"""BayesVLM on PyTorch and CUDA: the port of `bayesvlm_tpu` (JAX, TPU).

Post-hoc Kronecker-factored Laplace over the projection layers of frozen
CLIP towers, carried analytically into calibrated zero-shot
probabilities. The package mirrors `bayesvlm_tpu`'s module layout and
public names; it imports torch and numpy, never JAX. The vision towers'
attention runs through a hand-written CUDA kernel on the card
(models/attention.py, csrc/attention.cu) and its plain PyTorch version
on the CPU.
"""

from bayesvlm_tpu_torch.bayes.kfac import KroneckerFactorizedCovariance
from bayesvlm_tpu_torch.types import EncoderResult, ProbabilisticLogits

__all__ = [
    "EncoderResult",
    "ProbabilisticLogits",
    "KroneckerFactorizedCovariance",
]
