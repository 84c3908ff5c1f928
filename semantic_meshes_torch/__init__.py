"""semantic-meshes on PyTorch and CUDA: mesh annotation by multi-view fusion
of 2D semantic segmentation.

Port of the JAX package `semantic_meshes` (the reference it is tested
against); it imports nothing from that package and nothing of JAX. The
public surface mirrors it: `data`, `render`, `fusion`, `data2` (ScanNet
`.sens`), plus `distributed` (batched pipeline), `geometry`, `io`,
`metrics`, `probs_io` (probability wires), `checkpoint`, `profiling`,
`models` (the bundled segmentation predictors), `testing`, `utils` and
`convert` (state from the JAX package). Entry
points take `device=` and default to "cuda"; the rasterizer's z-resolve
is a CUDA kernel for sm_90a built from `csrc/` at first use (see
`_build`), with a plain PyTorch version for CPU tensors; the `.sens` and
images.bin readers are a host C++ library built the same way by g++
(`native`).
"""

from . import checkpoint  # noqa: F401
from . import convert  # noqa: F401
from . import data  # noqa: F401
from . import data2  # noqa: F401
from . import distributed  # noqa: F401
from . import fusion  # noqa: F401
from . import geometry  # noqa: F401
from . import io  # noqa: F401
from . import metrics  # noqa: F401
from . import models  # noqa: F401
from . import ops  # noqa: F401
from . import probs_io  # noqa: F401
from . import profiling  # noqa: F401
from . import rasterize  # noqa: F401
from . import render  # noqa: F401
from . import testing  # noqa: F401
from . import utils  # noqa: F401

__version__ = "0.1.0"
