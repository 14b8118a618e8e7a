"""BayesVLM on PyTorch and CUDA: the port of `bayesvlm_tpu` (JAX, TPU).

Post-hoc Kronecker-factored Laplace over the projection layers of frozen
CLIP towers, carried analytically into calibrated zero-shot
probabilities (Stage 2) and into online EPIG selection of images to
label (Stage 3, `select/`). The package mirrors `bayesvlm_tpu`'s module
layout and public names; it imports torch and numpy, never JAX. Every
TPU kernel it ports is a hand-written CUDA kernel on the card
(`csrc/*.cu`, built by kernels.py) beside its plain PyTorch version,
which runs on the CPU.
"""

from bayesvlm_tpu_torch.bayes.kfac import KroneckerFactorizedCovariance
from bayesvlm_tpu_torch.types import EncoderResult, ProbabilisticLogits

__all__ = [
    "EncoderResult",
    "ProbabilisticLogits",
    "KroneckerFactorizedCovariance",
]
