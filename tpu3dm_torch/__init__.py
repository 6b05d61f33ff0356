"""tpu3dm_torch — the PyTorch/CUDA port of tpu3dm for NVIDIA Hopper.

The JAX package ``tpu3dm`` is the reference; this package mirrors its layout
(``core``, ``io``, ``ops``, ``preprocess``, ``registration``, ``parallel``) and
keeps its function names, so each port has an obvious counterpart.  Plain
tensor code is PyTorch with an explicit leading pair dimension; every TPU
kernel on the ported path is a hand-written CUDA kernel in ``csrc/``, built
on first use.

This package never imports JAX or ``tpu3dm``.  Entry points run on CUDA
unless the caller passes ``device="cpu"``; without CUDA they raise instead of
falling back.
"""

import torch

# Registration is geometry: transform recovery degrades under reduced-precision
# matmul passes (TF32 keeps ~3 decimal digits).  Full fp32 everywhere, as the
# reference forces "highest"; bf16 appears only where a caller opts in
# (approx_score).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names another.

    Raises RuntimeError when CUDA is asked for (``device=None`` included) and
    is not available; there is no quiet CPU fallback.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "tpu3dm_torch: CUDA is not available; pass device='cpu' to run "
            "the plain PyTorch versions on the CPU"
        )
    return dev


from tpu3dm_torch.core.cloud import PointCloud, from_numpy  # noqa: E402
from tpu3dm_torch.core.config import (  # noqa: E402
    IcpConfig,
    PipelineConfig,
    PreprocessConfig,
    RansacConfig,
)

__version__ = "0.1.0"

__all__ = [
    "PointCloud",
    "from_numpy",
    "resolve_device",
    "PipelineConfig",
    "PreprocessConfig",
    "RansacConfig",
    "IcpConfig",
]
