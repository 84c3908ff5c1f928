"""The user scripts and the ScanNet drivers, on the port.

One module per script of the JAX repository's `scripts/` and
`eval-scannet/` directories, under the script's own name, with its flags
letter for letter plus `--device` (default "cuda"; a CUDA request without
a card raises). Each has `parse_args(argv)` and `main(argv=None)` and
runs as `python -m semantic_meshes_torch.scripts.<name>`:

- colorize_mesh, render_annotations, precompute_probs,
  colorize_cityscapes_mesh, demo_cube, debug_render_texels: the
  reference workflow (masks or probabilities -> render -> fuse -> colours
  -> PLY or re-rendered annotations);
- create_scannet_eval_graphs, make_paper_graphs, run_colmap_on_scannet,
  simplify_scannet_meshes: the ScanNet drivers (the last two drive the
  external `colmap` and `meshlabserver` binaries and need no card);
- bench_cityscapes, bench_eval, resume_killtest: timings of the demo and
  of the eval entry point, and the eval's SIGKILL resume check.

Images are read and written by `io.image` (Pillow); nothing here imports
imageio. The modules import nothing at package import time.
"""
