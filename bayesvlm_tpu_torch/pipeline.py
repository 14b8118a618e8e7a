"""One-call API for probabilistic zero-shot inference (Stage 2).

Counterpart of `bayesvlm_tpu.pipeline.ProbabilisticVLM`: the reference's
Stage-2 chain (ref:scripts/zeroshot.py:25-128) behind one constructor
and one call, with the same semantics (lambda re-optimised with
pseudo_data_count=10, init 300, lr 1e-2, 1000 Adam steps; probit softmax
when num_samples=0, Monte-Carlo otherwise).

    vlm = ProbabilisticVLM.from_pretrained(
        "clip-large", hessian_dir, dtype="bf16", device="cuda")
    vlm.set_class_prompts(["An image of a cat", "An image of a dog"])
    probs = vlm.predict(images)           # [B, C] calibrated probs
    logits = vlm.logits(images)           # ProbabilisticLogits (mean+var)

Both families: the CLIP and SigLIP names of `models/configs.py`.
`predict` takes normalised NHWC float pixels, or PIL images, which go
through the family's transform (`data/transforms.get_transform`).

The W8A8 int8 lane of the vision tower is an opt-in, as in the JAX
package (`--mlp_int8` in its CLIs):

    vlm = ProbabilisticVLM.from_pretrained(
        "clip-large", hessian_dir, dtype="bf16", mlp_int8=True,
        attn_int8=True)

Real checkpoints: `weights_dir` is an HF snapshot directory
(`*.safetensors` or `pytorch_model*.bin`) or the port's converted
`vision.pt` / `text.pt` (`python -m bayesvlm_tpu_torch.convert_weights`),
and `tokenizer_dir` a local HF tokenizer directory (needs
`transformers`); without it, prompts go through the deterministic
`HashTokenizer`.

Not ported yet: AOT serving (`compile_serving`, the serving cache) and
meshes.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch

from bayesvlm_tpu_torch.types import EncoderResult, ProbabilisticLogits

_DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}


class ProbabilisticVLM:
    def __init__(self, image_encoder, text_encoder, head, info: dict,
                 transform=None):
        self.image_encoder = image_encoder
        self.text_encoder = text_encoder
        self.head = head
        self.info = dict(info)
        self.transform = transform
        self._label_features: Optional[EncoderResult] = None

    @classmethod
    def from_pretrained(
        cls,
        model_str: str,
        hessian_dir: str,
        weights_dir: Optional[str] = None,
        tokenizer_dir: Optional[str] = None,
        pseudo_data_count: int = 10,
        dtype: str = "bf16",
        lambda_init: float = 300.0,
        prior_lr: float = 1e-2,
        prior_num_steps: int = 1000,
        mlp_int8: bool = False,
        attn_int8: bool = False,
        seed: int = 0,
        device: Union[str, torch.device] = "cuda",
    ) -> "ProbabilisticVLM":
        """Load towers + K-FAC posterior and finalize covariances, in the
        reference's order (ref:scripts/zeroshot.py:54-94): towers, lambda
        for the image side, lambda for the text side, covariances, head.
        Runs on the card unless `device` names another.

        `mlp_int8` / `attn_int8`: the vision tower's W8A8 int8 lanes
        (models/encoders.load_model). The GEMM weights are cast to the
        compute dtype first, then the MLP weight cache is quantized from
        those rounded values, as on the TPU.

        `weights_dir`: an HF snapshot or the port's converted weights
        (models/encoders.load_model); `tokenizer_dir`: a local HF
        tokenizer (data/tokenizer.HFTokenizer), else `HashTokenizer`.
        `seed` only matters when weights_dir is None (random-init towers
        for tests and benchmarks)."""
        from bayesvlm_tpu_torch.bayes.kfac import compute_covariances
        from bayesvlm_tpu_torch.bayes.prior import optimize_prior_precision
        from bayesvlm_tpu_torch.data.tokenizer import make_tokenizer
        from bayesvlm_tpu_torch.data.transforms import get_transform
        from bayesvlm_tpu_torch.io.artifacts import load_hessians
        from bayesvlm_tpu_torch.models.encoders import load_model
        from bayesvlm_tpu_torch.utils import get_image_size

        device = torch.device(device)
        # load_model casts the GEMM weights to the compute dtype; the
        # int8 cache is quantized after that
        image_encoder, text_encoder, head = load_model(
            model_str, weights_dir=weights_dir, dtype=_DTYPES[dtype],
            seed=seed, device=device, mlp_int8=mlp_int8, attn_int8=attn_int8)
        image_encoder.prequantize_int8()
        text_encoder.tokenizer = make_tokenizer(image_encoder.config.text, tokenizer_dir)

        A_img, B_img = (F.to(device) for F in load_hessians(hessian_dir, "img"))
        A_txt, B_txt = (F.to(device) for F in load_hessians(hessian_dir, "txt"))
        info = {"n_img": pseudo_data_count, "n_txt": pseudo_data_count}
        info["lambda_img"] = float(optimize_prior_precision(
            image_encoder.projection_l2(),
            image_encoder.projection_num_params(),
            A=A_img, B=B_img, lmbda_init=lambda_init, n=info["n_img"],
            lr=prior_lr, num_steps=prior_num_steps,
        ))
        info["lambda_txt"] = float(optimize_prior_precision(
            text_encoder.projection_l2(),
            text_encoder.projection_num_params(),
            A=A_txt, B=B_txt, lmbda_init=lambda_init, n=info["n_txt"],
            lr=prior_lr, num_steps=prior_num_steps,
        ))
        cov_img, cov_txt = compute_covariances(A_img, B_img, A_txt, B_txt, info)
        head = head.set_covariances(cov_img, cov_txt)
        transform = get_transform(image_encoder.config.family,
                                  get_image_size(model_str))
        return cls(image_encoder, text_encoder, head, info, transform=transform)

    # -- encoding -------------------------------------------------------

    def encode_images(self, images, batch_size: int = 256) -> EncoderResult:
        """Encode NHWC (or NCHW) normalized float pixels, or a list of PIL
        images (run through the model's transform), in batches of at most
        `batch_size` (bounded device memory for large inputs)."""
        from bayesvlm_tpu_torch.inference.precompute import encode_images_batched

        if isinstance(images, (list, tuple)):
            if self.transform is None:
                raise ValueError("PIL inputs need a transform; construct "
                                 "via from_pretrained")
            images = np.stack([self.transform(im) for im in images])
        return encode_images_batched(self.image_encoder, images, batch_size)

    def encode_texts(self, prompts: Sequence[str]) -> EncoderResult:
        return self.text_encoder.encode_texts(list(prompts))

    def set_class_prompts(self, prompts: Sequence[str]) -> "ProbabilisticVLM":
        """Embed and cache the label set once for repeated predict calls."""
        self._label_features = self.encode_texts(prompts)
        return self

    # -- inference ------------------------------------------------------

    def logits(self, images, class_prompts: Optional[Sequence[str]] = None,
               batch_size: int = 256) -> ProbabilisticLogits:
        """Probabilistic similarity logits (mean + variance) of images vs
        the class prompts (ref:bayesvlm/precompute.py:18-65 +
        vlm.py:630-684 semantics)."""
        from bayesvlm_tpu_torch.inference.predictions import make_predictions

        if class_prompts is not None:
            labels = self.encode_texts(class_prompts)
        elif self._label_features is not None:
            labels = self._label_features
        else:
            raise ValueError("pass class_prompts or call set_class_prompts")
        feats = images if isinstance(images, EncoderResult) \
            else self.encode_images(images, batch_size=batch_size)
        return make_predictions(self.head, feats, labels, batch_size=batch_size)

    def predict(self, images, class_prompts: Optional[Sequence[str]] = None,
                num_samples: int = 0, seed: int = 0,
                batch_size: int = 256) -> torch.Tensor:
        """Calibrated class probabilities [B, C] on the model's device:
        probit approximation when num_samples=0
        (ref:scripts/zeroshot.py:119-120), MC softmax otherwise
        (ref:bayesvlm/vlm.py:80-103)."""
        pl = self.logits(images, class_prompts, batch_size=batch_size)
        return pl.softmax(num_samples=num_samples, seed=seed)
