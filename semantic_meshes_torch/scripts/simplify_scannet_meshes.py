"""Port of eval-scannet/simplify_scannet_meshes.py: simplify ScanNet meshes
by quadric edge collapse through meshlabserver.

    python -m semantic_meshes_torch.scripts.simplify_scannet_meshes
        --scannet DIR --factor F [--factor F ...]
        [--meshlabserver meshlabserver]

For each factor and each scene under DIR/scans, writes a MeshLab filter
script targeting factor x the face count of
`<scene>_vh_clean_2.labels.ply` (read by io.ply.read_mesh) and runs the
external meshlabserver on it (under xvfb-run where that exists), writing
`<scene>_vh_clean_2.labels_simplified-<factor>.ply`. The driver works on
the host only, so it takes no `--device`.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
import tempfile

FILTER_TEMPLATE = """<!DOCTYPE FilterScript>
<FilterScript>
 <filter name="Simplification: Quadric Edge Collapse Decimation">
  <Param value="{faces_num}" name="TargetFaceNum" type="RichInt" description="Target number of faces"/>
  <Param value="0" name="TargetPerc" type="RichFloat" description="Percentage reduction (0..1)"/>
  <Param value="0.3" name="QualityThr" type="RichFloat" description="Quality threshold"/>
  <Param value="false" name="PreserveBoundary" type="RichBool" description="Preserve Boundary of the mesh"/>
  <Param value="1" name="BoundaryWeight" type="RichFloat" description="Boundary Preserving Weight"/>
  <Param value="false" name="PreserveNormal" type="RichBool" description="Preserve Normal"/>
  <Param value="false" name="PreserveTopology" type="RichBool" description="Preserve Topology"/>
  <Param value="true" name="OptimalPlacement" type="RichBool" description="Optimal position of simplified vertices"/>
  <Param value="false" name="PlanarQuadric" type="RichBool" description="Planar Simplification"/>
  <Param value="0.001" name="PlanarWeight" type="RichFloat" description="Planar Simp. Weight"/>
  <Param value="false" name="QualityWeight" type="RichBool" description="Weighted Simplification"/>
  <Param value="true" name="AutoClean" type="RichBool" description="Post-simplification cleaning"/>
  <Param value="false" name="Selected" type="RichBool" description="Simplify only selected faces"/>
 </filter>
</FilterScript>
"""


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Simplify meshes in the scannet dataset by the given "
        "factor"
    )
    parser.add_argument("--scannet", type=str, required=True)
    parser.add_argument("--factor", action="append", type=float,
                        required=True,
                        help="Fraction of faces to keep (repeatable)")
    parser.add_argument("--meshlabserver", type=str, default="meshlabserver")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from ..io.ply import read_mesh

    scans_dir = os.path.join(args.scannet, "scans")
    scenes = sorted(os.path.join(scans_dir, f) for f in os.listdir(scans_dir)
                    if f.startswith("scene"))
    print(f"Found {len(scenes)} scenes in {args.scannet}")
    # meshlabserver needs a display: wrap it in xvfb-run where available
    prefix = ('xvfb-run -a -s "-screen 0 800x600x24" '
              if shutil.which("xvfb-run") else "")
    for factor in args.factor:
        print(f"Simplifying meshes with factor {factor}")
        for scene in scenes:
            name = os.path.basename(scene)
            input_mesh = os.path.join(scene, name + "_vh_clean_2.labels.ply")
            output_mesh = os.path.join(
                scene, name + f"_vh_clean_2.labels_simplified-{factor}.ply")
            _, faces = read_mesh(input_mesh)
            faces_num = int(factor * len(faces))
            with tempfile.NamedTemporaryFile("w", suffix=".mlx") as tmp:
                tmp.write(FILTER_TEMPLATE.format(faces_num=faces_num))
                tmp.flush()
                cmd = (f"{prefix}{args.meshlabserver} -i {input_mesh} "
                       f"-s {tmp.name} -o {output_mesh}")
                subprocess.run(["bash", "-c", cmd], check=True,
                               stdout=subprocess.DEVNULL)
    return 0


if __name__ == "__main__":
    sys.exit(main())
