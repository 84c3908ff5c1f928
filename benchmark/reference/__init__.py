"""The plain reference of the benchmark: a frozen rasterizer, the texel
mapping and the fusion, in float64 PyTorch.

It imports nothing of the program (`semantic_meshes_torch`), nothing of
JAX and nothing of the JAX package. From the same mesh, cameras and
probabilities that the program was handed, it works out again what the
timed path produced, and `check.compare` judges the program's fused
accumulators against it.

Semantics (the program's contract): pixel centres at (x + 0.5, y + 0.5);
a pixel is inside a triangle when all three edge functions, signed by the
triangle's orientation, are >= 0; the winner is the largest inverse depth,
the lowest id on a tie; a triangle with a vertex at z <= 1e-6 is culled.
The reference computes in float64, so it knows the exact answer of the
float32 inputs. Where a float32 implementation could decide either way
(a pixel centre within rounding of an edge, or two depths within rounding
of each other), the pixel is fragile: its possible owners are recorded,
and the comparison allows each of them the pixel's contribution.
"""
