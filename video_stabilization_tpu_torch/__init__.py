"""video_stabilization_tpu_torch — the PyTorch / CUDA port of video_stabilization_tpu.

The same layout and public names as the JAX package, for one NVIDIA Hopper
GPU: plain tensor code is PyTorch, and the JAX package's Pallas kernels
become hand-written CUDA kernels (``csrc/``), each with a plain PyTorch
version that runs on the CPU.  The port shares no module with the JAX
package and imports no JAX: ``config.py`` is its own copy of the JAX
package's configuration, and ``config_from_fields`` carries a configuration
across.

Subpackages
-----------
- ``motion`` : homography decompose/compose, similarity fitting, RANSAC,
  the host replica of cv2's RANSAC.
- ``models`` : the motion-model family (rigid, similarity, affine,
  homography).
- ``ops``    : image ops, pyramid, gradients, GFTT (cell, cv2-exact and
  the host replica), LK (dense, sweep, cv2-exact), warps, trail
  compositing, the registration filters, FAST, ORB, patch extraction,
  Hamming matching.
- ``engine`` : carry, per-frame step, offline chunks, smoothing,
  registration lock, ``Stabilizer``.
- ``parallel``: many streams: a stream dimension in the carry, sharded over
  a mesh of cards.
- ``sim``    : the floor-texture camera simulator with analytic truth.
- ``io``     : frame sources and sinks, the native Y4M reader and rings.
- ``cli``    : the application (``python -m video_stabilization_tpu_torch.cli``).
- ``serve``  : the multi-stream serving harness
  (``python -m video_stabilization_tpu_torch.serve``).
- ``utils``  : the threefry PRNG, the CUDA kernel build helper, timing and
  the stage profiler.
"""

from video_stabilization_tpu_torch.config import (  # noqa: F401
    StabilizationMode,
    StabilizerConfig,
    config_from_fields,
)
