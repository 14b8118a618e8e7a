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
`predict` takes normalised NHWC float pixels, uint8 crops (the
`*_uint8` transforms; normalised on the device), or PIL images, which go
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

Serving: `compile_serving(batch_sizes, input_dtype)` builds one program
per batch size (pixels -> image tower -> Smith head -> probit softmax).
On the card each is a CUDA graph captured over a static input buffer,
the counterpart of the JAX package's AOT ladder; `predict` replays it
when the call matches its signature, and `serve.BatchingServer` batches
requests onto it:

    vlm.compile_serving([1, 2, 4, 8], input_dtype=torch.uint8)
    probs = vlm.predict(uint8_batch_of_8)   # one graph replay

The serving state persists (`save_serving`), and a restart brings it up
without the Hessian directory, the lambda re-opt or the text tower:

    vlm.save_serving("serving.aotserv")
    vlm = ProbabilisticVLM.from_serving_cache("clip-large", "serving.aotserv")

A CUDA graph cannot be written to a file, so the file holds the ladder's
signature and the runtime state, and the ladder is captured again at
load.

Serving mesh (JAX `bayesvlm_tpu/pipeline.py:130-153, 291-325, 687-698`):
with more than one card visible, `from_pretrained(..., mesh="auto")`
places one replica of the image tower (with the label features and the
head) on each card (`serving_mesh.ServingMesh`), and every batch is split
into contiguous row blocks, one a replica. `mesh=None` turns it off; a
sequence of devices forces it on and may repeat a device:

    vlm = ProbabilisticVLM.from_pretrained(
        "clip-large", hessian_dir, mesh=["cuda:0", "cuda:1"])
    vlm.compile_serving([2, 64], input_dtype=torch.uint8)  # sizes % 2 == 0

Each ladder size is then one CUDA graph a replica over b/n rows, on the
replica's device and its own stream; a call launches every replica
before it waits on any and gathers the probabilities onto the first
device in row order. The general path (`encode_images`, `logits`,
`predict` off the ladder) runs the tower, then the head, a block a
replica in the same way; without a mesh that is the one device's
forward. The other replicas hold copies of the first one's tower, head
and label features, made at construction and by `compile_serving`, and
anew for a part replaced (`image_encoder`, `head`, a label set of
another class count); `set_class_prompts` writes a label set of the
same count into every replica. An in-place change to the first
replica's weights reaches the others at the next `compile_serving`.
"""

from __future__ import annotations

import copy
import dataclasses
import os
import warnings
from typing import Optional, Sequence, Union

import numpy as np
import torch

from bayesvlm_tpu_torch.serving_mesh import AXIS, ServingMesh, resolve_serving_mesh
from bayesvlm_tpu_torch.types import EncoderResult, ProbabilisticLogits

_DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}
# numpy pixel dtypes a serving program can take (by `np.dtype.str`)
_TORCH_DTYPES = {np.dtype(d).str: t for d, t in (
    (np.uint8, torch.uint8), (np.float16, torch.float16),
    (np.float32, torch.float32), (np.float64, torch.float64))}

# Bump when the save_serving payload layout changes: load_serving refuses
# other versions (the JAX package's _AOT_CACHE_VERSION plays this part
# for its own, unreadable here, .aotserv pickles). 2: the "mesh" layout
_SERVING_CACHE_VERSION = 2
_LABEL_FIELDS = ("embeds", "activations", "residuals")


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _read_serving_file(path) -> dict:
    """The payload of a save_serving file, read with weights_only=True.
    A missing file raises FileNotFoundError (the caller's "no cache");
    anything else it cannot read raises ValueError (the caller's "stale"),
    the JAX package's .aotserv pickles by name."""
    path = str(path)
    with open(path, "rb") as f:
        head = f.read(4096)
    try:
        with warnings.catch_warnings():
            # a foreign pickle's protocol warning: the refusal below says more
            warnings.simplefilter("ignore", UserWarning)
            payload = torch.load(path, map_location="cpu", weights_only=True)
    except Exception as exc:  # noqa: BLE001 — every unreadable file is refused
        if not head.startswith(b"PK") and b"jax" in head:
            raise ValueError(
                f"serving cache {path} is a JAX package .aotserv pickle (compiled "
                "XLA programs); this package cannot read it: build with "
                "from_pretrained + compile_serving and save_serving again") from exc
        raise ValueError(f"serving cache {path} is torn or not a save_serving file "
                         f"({type(exc).__name__}: {exc})") from exc
    if not isinstance(payload, dict):
        raise ValueError(f"serving cache {path} is not a save_serving file")
    if payload.get("version") != _SERVING_CACHE_VERSION:
        raise ValueError(f"AOT cache version {payload.get('version')} != "
                         f"{_SERVING_CACHE_VERSION}")
    return payload


def _device_signature(device: torch.device) -> dict:
    """What a saved ladder must match on the running process: the JAX
    package's platform / device_kind / num_devices."""
    if device.type == "cuda":
        return {"platform": "cuda", "device_kind": torch.cuda.get_device_name(device),
                "num_devices": torch.cuda.device_count()}
    return {"platform": device.type, "device_kind": device.type, "num_devices": 1}


def _head_state(head) -> dict:
    """The head as plain tensors, numbers and dicts (host copies)."""
    def cov(c):
        return None if c is None else {"A_inv": c.A_inv.cpu(), "B_inv": c.B_inv.cpu()}

    return {"logit_scale": head.logit_scale.cpu(), "logit_bias": head.logit_bias.cpu(),
            "source_covariance": cov(head.source_covariance),
            "target_covariance": cov(head.target_covariance),
            "source_projection_has_bias": bool(head.source_projection_has_bias),
            "target_projection_has_bias": bool(head.target_projection_has_bias)}


def _head_from_state(state: dict, device: torch.device):
    from bayesvlm_tpu_torch.bayes.kfac import KroneckerFactorizedCovariance
    from bayesvlm_tpu_torch.probforward.smith import ProbabilisticHead

    def cov(c):
        return None if c is None else KroneckerFactorizedCovariance(
            A_inv=c["A_inv"].to(device), B_inv=c["B_inv"].to(device))

    return ProbabilisticHead(
        logit_scale=state["logit_scale"].to(device), logit_bias=state["logit_bias"].to(device),
        source_covariance=cov(state["source_covariance"]),
        target_covariance=cov(state["target_covariance"]),
        source_projection_has_bias=state["source_projection_has_bias"],
        target_projection_has_bias=state["target_projection_has_bias"])


def _head_copy(head, device: torch.device):
    """The head with every tensor copied onto `device` (a replica's)."""
    def cov(c):
        return None if c is None else dataclasses.replace(
            c, A_inv=c.A_inv.to(device, copy=True), B_inv=c.B_inv.to(device, copy=True))

    return dataclasses.replace(
        head, logit_scale=head.logit_scale.to(device, copy=True),
        logit_bias=head.logit_bias.to(device, copy=True),
        source_covariance=cov(head.source_covariance),
        target_covariance=cov(head.target_covariance))


def _head_tensors(head) -> list:
    tensors = [head.logit_scale, head.logit_bias]
    for cov in (head.source_covariance, head.target_covariance):
        if cov is not None:
            tensors += [cov.A_inv, cov.B_inv]
    return tensors


def _label_tensors(labels) -> list:
    return [] if labels is None else [getattr(labels, f) for f in _LABEL_FIELDS]


def _labels_copy(labels, device: torch.device):
    return None if labels is None else EncoderResult(
        *(t.to(device, copy=True) for t in _label_tensors(labels)))


def _module_tensors(module) -> list:
    # (walking the modules' dicts directly costs about half of
    # parameters() + buffers())
    return [t for m in module.modules() for d in (m._parameters, m._buffers)
            for t in d.values() if t is not None]


class _Replica:
    """What one device of the serving mesh reads: its image tower, label
    features and head. Replica 0 is the VLM's own; the others are copies
    (`ProbabilisticVLM._replicas`)."""

    __slots__ = ("device", "encoder", "labels", "head")

    def __init__(self, device, encoder, labels, head):
        self.device, self.encoder, self.labels, self.head = device, encoder, labels, head

    def tensors(self) -> list:
        """Every tensor the serving forward reads on this replica, in a
        fixed order: the tower's parameters and buffers (the int8 weight
        cache among them), the label features and the head."""
        return (_module_tensors(self.encoder.module) + _label_tensors(self.labels)
                + _head_tensors(self.head))


class _EagerProgram:
    """A ladder size on the CPU: the serving forward, run eagerly, a row
    block a replica, gathered on the first replica's device."""

    def __init__(self, vlm: "ProbabilisticVLM", dtype: torch.dtype):
        self.vlm, self.dtype = vlm, dtype

    def __call__(self, pixels) -> torch.Tensor:
        replicas = self.vlm._replicas()
        x = torch.as_tensor(pixels).to(self.dtype)
        rows = x.shape[0] // len(replicas)
        outs = [self.vlm._serve_forward(x[i * rows:(i + 1) * rows].to(rep.device), rep)
                for i, rep in enumerate(replicas)]
        return outs[0] if len(outs) == 1 else torch.cat(
            [o.to(replicas[0].device) for o in outs])


class _GraphPart:
    """One replica's CUDA graph of a ladder size over its block of rows;
    `stream` None replays on the current stream (one replica)."""

    __slots__ = ("graph", "static_in", "static_out", "stream", "device")

    def __init__(self, graph, static_in, static_out, stream, device):
        self.graph, self.static_in, self.static_out = graph, static_in, static_out
        self.stream, self.device = stream, device


class _GraphProgram:
    """A ladder size on the card: one CUDA graph of the serving forward a
    replica, each over a static input buffer of its block of rows. Host
    pixels are copied into a pinned staging buffer, then each block into
    its replica's static input on that device's current stream. With more
    than one replica each graph replays on its own stream: every replica
    is launched before any is waited on, then the outputs are gathered
    onto the first device in row order. The output is copied off the
    static buffers, which the next replay overwrites (a replica's next
    replay waits for that copy)."""

    def __init__(self, parts: list, out_device: torch.device):
        self.parts, self.out_device = parts, out_device
        self.rows = parts[0].static_in.shape[0]
        first = parts[0].static_in
        self.pinned = torch.empty((self.rows * len(parts), *first.shape[1:]),
                                  dtype=first.dtype, pin_memory=True)
        self.staged = []  # each part's last copy out of `pinned`
        for part in parts:
            with torch.cuda.device(part.device):
                event = torch.cuda.Event()
                event.record()
            self.staged.append(event)

    def __call__(self, pixels) -> torch.Tensor:
        on_card = isinstance(pixels, torch.Tensor) and pixels.device.type == "cuda"
        if not on_card:
            host = pixels.numpy() if isinstance(pixels, torch.Tensor) else np.asarray(pixels)
            for event in self.staged:
                event.synchronize()  # never overwrite a copy still in flight
            np.copyto(self.pinned.numpy(), host, casting="same_kind")
        src = pixels if on_card else self.pinned
        for i, part in enumerate(self.parts):
            block = src[i * self.rows:(i + 1) * self.rows]
            with torch.cuda.device(part.device):
                current = torch.cuda.current_stream()
                part.static_in.copy_(block, non_blocking=not on_card)
                if not on_card:
                    self.staged[i].record(current)
                if part.stream is None:
                    part.graph.replay()
                else:
                    # its input is in place, and its last output copied off
                    part.stream.wait_stream(current)
                    with torch.cuda.stream(part.stream):
                        part.graph.replay()
        if len(self.parts) == 1:
            return self.parts[0].static_out.clone()
        for part in self.parts:
            with torch.cuda.device(part.device):
                torch.cuda.current_stream().wait_stream(part.stream)
        return torch.cat([part.static_out.to(self.out_device) for part in self.parts])


class ProbabilisticVLM:
    def __init__(self, image_encoder, text_encoder, head, info: dict,
                 transform=None, mesh=None):
        """`mesh`: the serving mesh on the image tower's device, "auto",
        None, a ServingMesh or a sequence of devices
        (serving_mesh.resolve_serving_mesh)."""
        self.image_encoder = image_encoder
        self.text_encoder = text_encoder
        self.head = head
        self.info = dict(info)
        self.transform = transform
        self.mesh = resolve_serving_mesh(mesh, image_encoder.device)
        self._label_features: Optional[EncoderResult] = None
        self._class_prompts: Optional[list] = None
        self._serving: Optional[dict] = None
        # the other replicas of the mesh (_mirrors) and the first one's
        # encoder, head and label features they were copied from (_mirrored)
        self._make_mirrors()
        # predict calls served by the ladder (a graph replay on the card,
        # its eager program on the CPU) and by the general path
        self.replays = 0
        self.eager_calls = 0

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
        mesh="auto",
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
        for tests and benchmarks).

        `mesh`: the serving mesh (module docstring). "auto" (the default,
        as in JAX) takes every visible card when there is more than one,
        None turns it off, a sequence of devices forces it on; its first
        device is `device`."""
        from bayesvlm_tpu_torch.bayes.kfac import compute_covariances
        from bayesvlm_tpu_torch.bayes.prior import optimize_prior_precision
        from bayesvlm_tpu_torch.io.artifacts import load_hessians

        image_encoder, text_encoder, head, transform = cls._build_towers(
            model_str, weights_dir, tokenizer_dir, dtype, mlp_int8, attn_int8, seed,
            device)
        device = image_encoder.device
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
        return cls(image_encoder, text_encoder, head, info, transform=transform,
                   mesh=mesh)

    @classmethod
    def _build_towers(cls, model_str, weights_dir, tokenizer_dir, dtype, mlp_int8,
                      attn_int8, seed, device):
        """Weights-only construction shared by from_pretrained and
        from_serving_cache (JAX `bayesvlm_tpu/pipeline.py:102`): the towers
        (GEMM weights cast to the compute dtype, then the int8 cache
        quantized from those rounded values), the tokenizer, the head
        without covariances and the transform. No Hessian directory, no
        lambda re-opt, no forward pass."""
        from bayesvlm_tpu_torch.data.tokenizer import make_tokenizer
        from bayesvlm_tpu_torch.data.transforms import get_transform
        from bayesvlm_tpu_torch.models.encoders import load_model
        from bayesvlm_tpu_torch.utils import get_image_size

        image_encoder, text_encoder, head = load_model(
            model_str, weights_dir=weights_dir, dtype=_DTYPES[dtype],
            seed=seed, device=torch.device(device), mlp_int8=mlp_int8,
            attn_int8=attn_int8)
        image_encoder.prequantize_int8()
        text_encoder.tokenizer = make_tokenizer(image_encoder.config.text, tokenizer_dir)
        transform = get_transform(image_encoder.config.family, get_image_size(model_str))
        return image_encoder, text_encoder, head, transform

    @classmethod
    def from_serving_cache(
        cls,
        model_str: str,
        path,
        weights_dir: Optional[str] = None,
        tokenizer_dir: Optional[str] = None,
        dtype: str = "bf16",
        mlp_int8: bool = False,
        attn_int8: bool = False,
        seed: int = 0,
        device: Union[str, torch.device] = "cuda",
        mesh="auto",
    ) -> "ProbabilisticVLM":
        """Bring a serving VLM up from a `save_serving(...,
        include_runtime=True)` file (JAX `bayesvlm_tpu/pipeline.py:156`):
        the towers built from weights alone (`_build_towers`), the label
        features, the covariance-finalised head, `info` (the lambdas) and
        the class prompts restored from the file, then `load_serving`
        captures the ladder. No Hessian directory is read, no lambda
        re-opt and no text tower runs. Every `load_serving` check applies,
        so a file of another family, dtype, class count or int8 setting is
        refused. The weights must be the ones the file was saved with:
        their shapes are checked, their values are the operator's
        contract, as with any checkpoint directory (the file holds no
        weights). `set_class_prompts` works afterwards as ever. `mesh` as
        in from_pretrained: a file saved on another mesh layout is
        refused."""
        payload = _read_serving_file(path)
        runtime = payload.get("runtime")
        if runtime is None:
            raise ValueError(
                "AOT cache was saved with include_runtime=False — it has "
                "no label features / head; use from_pretrained + "
                "load_serving instead")
        image_encoder, text_encoder, _, transform = cls._build_towers(
            model_str, weights_dir, tokenizer_dir, dtype, mlp_int8, attn_int8, seed,
            device)
        device = image_encoder.device
        vlm = cls(image_encoder, text_encoder, _head_from_state(runtime["head"], device),
                  info=dict(runtime["info"]), transform=transform, mesh=mesh)
        vlm._label_features = EncoderResult(**{
            f: runtime["label_features"][f].to(device) for f in _LABEL_FIELDS})
        vlm._class_prompts = runtime.get("class_prompts")
        return vlm._restore_ladder(payload)

    # -- encoding -------------------------------------------------------

    def encode_images(self, images, batch_size: int = 256) -> EncoderResult:
        """Encode NHWC (or NCHW) normalized float pixels or uint8 crops
        (normalised on the device), or a list of PIL images (run through
        the model's transform), in batches of at most `batch_size`
        (bounded device memory for large inputs). On a serving mesh each
        batch is split over the replicas (`_sharded_encode`)."""
        if isinstance(images, (list, tuple)):
            if self.transform is None:
                raise ValueError("PIL inputs need a transform; construct "
                                 "via from_pretrained")
            images = np.stack([self.transform(im) for im in images])
        return EncoderResult.concatenate([
            self._sharded_encode(images[start:start + batch_size])
            for start in range(0, len(images), batch_size)])

    # -- serving mesh -----------------------------------------------------

    def _sharded(self) -> bool:
        return self.mesh is not None and self.mesh.size > 1

    def _make_mirrors(self) -> None:
        """Copy the first replica's tower, head and label features onto the
        other devices of the mesh (the int8 cache comes with the tower)."""
        from bayesvlm_tpu_torch.models.encoders import ImageEncoder

        enc0, self._mirrors = self.image_encoder, []
        if self._sharded():
            enc0._validate_quant_cache()
            for device in self.mesh.devices[1:]:
                encoder = ImageEncoder(enc0.config, copy.deepcopy(enc0.module).to(device))
                # the int8 cache came with the weights it was quantized from
                encoder._quant_src = encoder._weight_key() if enc0._quant_src is not None \
                    else None
                self._mirrors.append(_Replica(device, encoder,
                                              _labels_copy(self._label_features, device),
                                              _head_copy(self.head, device)))
        self._mirrored = (enc0, self.head, self._label_features)

    def _replicas(self) -> list:
        """One _Replica a device of the mesh, the VLM's own first (alone
        without a mesh). A part of the first one that was replaced since
        the copies were made is copied anew (module docstring)."""
        first = _Replica(self.image_encoder.device, self.image_encoder,
                         self._label_features, self.head)
        if not self._sharded():
            return [first]
        enc, head, labels = self._mirrored
        if first.encoder is not enc:
            self._make_mirrors()
        else:
            for m in self._mirrors:
                if first.head is not head:
                    m.head = _head_copy(first.head, m.device)
                if first.labels is not labels:
                    m.labels = _labels_copy(first.labels, m.device)
            self._mirrored = (enc, first.head, first.labels)
        return [first, *self._mirrors]

    def _sharded_encode(self, images) -> EncoderResult:
        """One batch through the tower a row block a replica (JAX's
        `_shard_batch`: padded with zero rows to a multiple of the mesh's
        size), gathered on the first device, the padding cut. Every
        replica is launched before any result is gathered. Without a mesh,
        the tower on the whole batch."""
        replicas = self._replicas()
        n = len(replicas)
        x = torch.as_tensor(images)
        B = x.shape[0]
        pad = (-B) % n
        if pad:
            x = torch.cat([x, torch.zeros((pad, *x.shape[1:]), dtype=x.dtype,
                                          device=x.device)])
        rows = x.shape[0] // n
        parts = [rep.encoder(x[i * rows:(i + 1) * rows]) for i, rep in enumerate(replicas)]
        out = replicas[0].device
        return EncoderResult(*(torch.cat([getattr(r, f).to(out) for r in parts])[:B]
                               for f in _LABEL_FIELDS))

    def _sharded_logits(self, feats: EncoderResult, labels,
                        batch_size: int) -> ProbabilisticLogits:
        """The head a row block a replica (JAX `make_predictions_sharded`:
        the rows padded with the last one to a multiple of the mesh's
        size), in chunks of max(batch_size, n) rows (JAX
        `pipeline.py:687-698`), gathered on the first device. `labels`
        None: each replica's own label features. Without a mesh, the head
        in chunks of batch_size rows (`make_predictions`)."""
        replicas = self._replicas()
        n = len(replicas)
        out = replicas[0].device
        step = max(batch_size, n)
        chunks = []
        for start in range(0, len(feats), step):
            chunk = feats[start:start + step]
            N = len(chunk)
            pad = (-N) % n
            fields = [getattr(chunk, f) for f in _LABEL_FIELDS]
            if pad:
                fields = [torch.cat([t, t[-1:].expand(pad, *t.shape[1:])]) for t in fields]
            rows = (N + pad) // n
            parts = []
            for i, rep in enumerate(replicas):
                block = EncoderResult(*(t[i * rows:(i + 1) * rows].to(rep.device)
                                        for t in fields))
                lab = rep.labels if labels is None else EncoderResult(
                    *(t.to(rep.device) for t in _label_tensors(labels)))
                parts.append(rep.head(block, lab))
            chunks.append(ProbabilisticLogits(
                mean=torch.cat([p.mean.to(out) for p in parts])[:N],
                var=torch.cat([p.var.to(out) for p in parts])[:N]))
        return ProbabilisticLogits.concatenate(chunks)

    def encode_texts(self, prompts: Sequence[str]) -> EncoderResult:
        return self.text_encoder.encode_texts(list(prompts))

    def set_class_prompts(self, prompts: Sequence[str]) -> "ProbabilisticVLM":
        """Embed and cache the label set once for repeated predict calls.
        With a serving ladder, a label set of the same shape is copied into
        the tensors the ladder reads (the JAX package passes the labels to
        its programs at run time); another class count drops the ladder,
        as there (compile_serving again for the fast path)."""
        new = self.encode_texts(prompts)
        old = self._label_features
        self._class_prompts = list(prompts)
        if self._serving is not None and old is not None and all(
                getattr(old, f).shape == getattr(new, f).shape for f in _LABEL_FIELDS):
            with torch.inference_mode():
                for rep in self._replicas():
                    for a, b in zip(_label_tensors(rep.labels), _label_tensors(new)):
                        a.copy_(b)
            return self
        self._serving = None
        self._label_features = new
        return self

    # -- serving ladder ---------------------------------------------------

    def _serve_forward(self, pixels: torch.Tensor, replica: _Replica) -> torch.Tensor:
        """pixels [B, H, W, 3] on the replica's device -> probit
        probabilities [B, C]: the image tower, then the unfused Smith head,
        as in the JAX package's serving program (`pipeline.py:334-336`
        there)."""
        from bayesvlm_tpu_torch.probforward.smith import probabilistic_logits

        with torch.inference_mode():
            feats = replica.encoder.forward_pixels(pixels)
        return probabilistic_logits(replica.head, feats, replica.labels).probit_softmax()

    def _ladder_tensors(self, replicas: Optional[list] = None) -> list:
        """Every tensor the serving forward reads, replica after replica
        (_Replica.tensors), in a fixed order."""
        return [t for rep in (replicas or self._replicas()) for t in rep.tensors()]

    def _runtime_key(self, replicas: Optional[list] = None) -> tuple:
        """Address and layout of every tensor the serving forward reads, on
        every replica. A CUDA graph reads them where they were at its
        capture."""
        return tuple((t.data_ptr(), t.shape, t.stride(), t.dtype)
                     for t in self._ladder_tensors(replicas))

    def _ladder_avals(self) -> list:
        """Shape and dtype of every tensor the ladder reads, on one replica
        (the others hold copies): the JAX package's `arg_avals`, whose
        leaves are global arrays."""
        first = _Replica(self.image_encoder.device, self.image_encoder,
                         self._label_features, self.head)
        return [[list(t.shape), _dtype_name(t.dtype)] for t in first.tensors()]

    def _mesh_layout(self) -> Optional[dict]:
        """The saved mesh layout: JAX's {"axis", "size"}, None unsharded."""
        return {"axis": AXIS, "size": self.mesh.size} if self._sharded() else None

    def compile_serving(self, batch_size,
                        input_dtype: torch.dtype = torch.float32) -> "ProbabilisticVLM":
        """Build the serving ladder: one program per batch size (one int
        or a sequence), pixels [B, H, W, 3] of `input_dtype` -> image tower
        -> Smith head -> probit softmax. uint8 puts the /255 and mean / std
        inside the program. A repeat call replaces the whole ladder.

        On the card each size is one CUDA graph (the counterpart of the
        JAX package's AOT programs, `bayesvlm_tpu/pipeline.py:263`): warmed
        up eagerly first (kernel builds, shared-memory opt-ins and the
        tensor-map encoder's lookup happen outside the capture), then
        captured over a static input buffer, largest size first, all
        sizes in one memory pool. A failed capture raises, naming the
        size. On the CPU a size runs the same forward eagerly.

        `predict` takes a program when num_samples == 0, no class_prompts
        are passed, the images' shape matches and the batch size is on the
        ladder (floats of another width are cast; uint8 and floats are
        never converted into each other). The graphs read the weights, the
        label features and the head where they were captured: in-place
        updates are served as they are, `set_class_prompts` with the same
        class count copies the new labels in place, and a tensor that
        moved (a replaced parameter, head or int8 cache) sends the call to
        the general path, counted in `eager_calls`.

        On a serving mesh of n replicas every size must be a multiple of n
        (JAX's message); the other replicas are copied afresh from the
        first, then each captures its own graph over b/n rows on its
        device and its own stream, with its own memory pool (module
        docstring)."""
        if self._label_features is None:
            raise ValueError("call set_class_prompts before compile_serving")
        batch_sizes = sorted({int(b) for b in (
            batch_size if isinstance(batch_size, (list, tuple, set, frozenset))
            else [batch_size])})
        if not batch_sizes or batch_sizes[0] < 1:
            raise ValueError(f"batch sizes must be >= 1, got {batch_sizes}")
        if self._sharded():
            n = self.mesh.size
            bad = [b for b in batch_sizes if b % n != 0]
            if bad:
                raise ValueError(
                    f"compile_serving on a {n}-way '{AXIS}' mesh needs "
                    f"batch sizes divisible by {n}, got {bad}")
        if input_dtype != torch.uint8 and not input_dtype.is_floating_point:
            raise ValueError(f"serving input must be uint8 or floats, not {input_dtype}")
        self._serving = None  # a failed capture leaves no ladder
        enc = self.image_encoder
        enc._validate_quant_cache()
        self._make_mirrors()
        vcfg = enc.config.vision
        shape = (vcfg.image_size, vcfg.image_size, 3)
        replicas = self._replicas()
        if enc.device.type == "cuda":
            programs = self._capture_ladder(batch_sizes, shape, input_dtype, replicas)
        else:
            programs = {b: _EagerProgram(self, input_dtype) for b in batch_sizes}
        self._serving = dict(programs=programs, image_shape=shape, dtype=input_dtype,
                             runtime_key=self._runtime_key(replicas))
        return self

    def _capture_ladder(self, batch_sizes, shape, dtype, replicas: list) -> dict:
        n = len(replicas)
        parts = {b: [] for b in batch_sizes}
        for r, rep in enumerate(replicas):
            device, pool = rep.device, None
            stream = torch.cuda.Stream(device) if n > 1 else None
            for b in sorted(batch_sizes, reverse=True):
                try:
                    with torch.cuda.device(device):
                        static_in = torch.zeros((b // n, *shape), dtype=dtype, device=device)
                        side = torch.cuda.Stream(device)
                        side.wait_stream(torch.cuda.current_stream(device))
                        with torch.cuda.stream(side):
                            for _ in range(2):
                                self._serve_forward(static_in, rep)
                        torch.cuda.current_stream(device).wait_stream(side)
                        graph = torch.cuda.CUDAGraph()
                        with torch.cuda.graph(graph, pool=pool, stream=stream):
                            static_out = self._serve_forward(static_in, rep)
                        torch.cuda.synchronize(device)
                except Exception as exc:
                    where = f" on replica {r} ({device})" if n > 1 else ""
                    raise RuntimeError(f"compile_serving: capturing batch size {b}{where} "
                                       f"failed: {type(exc).__name__}: {exc}") from exc
                pool = graph.pool()
                parts[b].append(_GraphPart(graph, static_in, static_out, stream, device))
        return {b: _GraphProgram(parts[b], replicas[0].device) for b in batch_sizes}

    def save_serving(self, path, include_runtime: bool = True) -> str:
        """Write the serving ladder's signature, and with `include_runtime`
        the serving state, to `path` (JAX `bayesvlm_tpu/pipeline.py:366`).

        A CUDA graph cannot be written to a file, so no program is stored:
        `load_serving` captures the ladder again. The signature is the
        version, the platform, the device name and count, the image shape,
        the mesh layout, the input dtype, the ladder's batch sizes, and the shape and dtype
        of every tensor the ladder reads (`_ladder_avals`; the int8 cache
        among them). The runtime state is the label features, the
        covariance-finalised head, `info` (the lambdas) and the class
        prompts the labels were encoded from, so `from_serving_cache` can
        bring a server up without the Hessian directory, the lambda re-opt
        or the text tower. No weights are stored: point
        `from_serving_cache` at the same weights. Plain tensors, numbers,
        strings, lists and dicts, readable by `torch.load(...,
        weights_only=True)`, written atomically (a temporary file, then
        `os.replace`)."""
        srv = self._serving
        if srv is None:
            raise ValueError("no compiled serving ladder: call "
                             "compile_serving before save_serving")
        payload = {
            "version": _SERVING_CACHE_VERSION,
            **_device_signature(self.image_encoder.device),
            "mesh": self._mesh_layout(),
            "image_shape": list(srv["image_shape"]),
            "dtype": _dtype_name(srv["dtype"]),
            "batch_sizes": sorted(srv["programs"]),
            "arg_avals": self._ladder_avals(),
        }
        if include_runtime:
            labels = self._label_features
            payload["runtime"] = {
                "label_features": {f: getattr(labels, f).detach().cpu()
                                   for f in _LABEL_FIELDS},
                "head": _head_state(self.head),
                "info": dict(self.info),
                # what the labels were encoded from: serve_cli refuses a full
                # restore when the configured prompt set differs
                "class_prompts": (list(self._class_prompts)
                                  if self._class_prompts is not None else None),
            }
        path = str(path)
        tmp = f"{path}.tmp.{os.getpid()}"
        torch.save(payload, tmp)
        os.replace(tmp, path)
        return path

    def load_serving(self, path) -> "ProbabilisticVLM":
        """Bring the serving ladder of a `save_serving` file up on this VLM
        (JAX `bayesvlm_tpu/pipeline.py:515`). Raises ValueError, with the
        JAX package's messages, when the version, the platform, the device
        name or count, the tensors the ladder reads (their number, shapes
        or dtypes: another class count, projection or int8 setting) or the
        image shape or the mesh layout differ, and for any file it cannot read (a JAX
        `.aotserv` pickle by name, a torn file); callers fall back to
        compile_serving (serve_cli --aot_cache does). Then the ladder is
        captured afresh through compile_serving, for the file's sizes and
        input dtype (where JAX loads executables)."""
        if self._label_features is None:
            raise ValueError("call set_class_prompts before load_serving")
        return self._restore_ladder(_read_serving_file(path))

    def _restore_ladder(self, payload: dict) -> "ProbabilisticVLM":
        for key, want in _device_signature(self.image_encoder.device).items():
            if payload.get(key) != want:
                raise ValueError(f"AOT cache {key} mismatch: saved "
                                 f"{payload.get(key)!r}, runtime {want!r}")
        saved_mesh, sharded = payload.get("mesh"), self._sharded()
        if bool(saved_mesh) != sharded:
            raise ValueError(
                f"AOT cache mesh layout mismatch: saved {saved_mesh}, runtime "
                f"{'sharded' if sharded else 'single-device'}")
        if sharded and (saved_mesh.get("axis") not in self.mesh.axis_names
                        or int(self.mesh.shape[saved_mesh["axis"]]) != saved_mesh["size"]):
            raise ValueError(f"AOT cache mesh mismatch: saved {saved_mesh}, "
                             f"runtime axes {dict(self.mesh.shape)}")
        enc = self.image_encoder
        enc._validate_quant_cache()
        avals, saved = self._ladder_avals(), payload["arg_avals"]
        if len(avals) != len(saved):
            raise ValueError("AOT cache runtime-argument structure mismatch "
                             "(e.g. int8 cache present on one side only)")
        if avals != saved:
            i, a, b = next((i, a, b) for i, (a, b) in enumerate(zip(avals, saved))
                           if a != b)
            raise ValueError(
                f"AOT cache runtime-argument shape/dtype mismatch at "
                f"leaf {i}: runtime {a}, saved {b} "
                f"(changed class count / projection / weights layout?)")
        size = enc.config.vision.image_size
        if list(payload["image_shape"]) != [size, size, 3]:
            raise ValueError(f"AOT cache image shape {tuple(payload['image_shape'])} "
                             f"!= model {(size, size, 3)}")
        dtype = getattr(torch, str(payload["dtype"]), None)
        if not isinstance(dtype, torch.dtype):
            raise ValueError(f"AOT cache input dtype {payload['dtype']!r} is not a dtype")
        return self.compile_serving(payload["batch_sizes"], input_dtype=dtype)

    def _predict_fast(self, images, num_samples: int,
                      class_prompts) -> Optional[torch.Tensor]:
        """Run the ladder's program when the call matches its signature;
        None -> the general path."""
        srv = self._serving
        if (srv is None or num_samples != 0 or class_prompts is not None
                or isinstance(images, EncoderResult)):
            return None
        if isinstance(images, (list, tuple)):
            if self.transform is None:
                return None
            images = np.stack([self.transform(im) for im in images])
        if not isinstance(images, torch.Tensor):
            images = np.asarray(images)
        if images.ndim != 4 or tuple(images.shape[1:]) != srv["image_shape"]:
            return None
        program = srv["programs"].get(int(images.shape[0]))
        if program is None:
            return None
        want = srv["dtype"]
        got = images.dtype if isinstance(images, torch.Tensor) else _TORCH_DTYPES.get(
            images.dtype.str)
        if got is None:
            return None
        if got != want and not (got.is_floating_point and want.is_floating_point):
            # casting across uint8 / float would skip (or fake) the
            # program's normalisation
            return None
        self.image_encoder._validate_quant_cache()
        if self._runtime_key() != srv["runtime_key"]:
            return None  # a tensor the program reads has moved
        return program(images)

    # -- inference ------------------------------------------------------

    def logits(self, images, class_prompts: Optional[Sequence[str]] = None,
               batch_size: int = 256) -> ProbabilisticLogits:
        """Probabilistic similarity logits (mean + variance) of images vs
        the class prompts (ref:bayesvlm/precompute.py:18-65 +
        vlm.py:630-684 semantics)."""
        if class_prompts is not None:
            labels = self.encode_texts(class_prompts)
        elif self._label_features is not None:
            labels = self._label_features
        else:
            raise ValueError("pass class_prompts or call set_class_prompts")
        feats = images if isinstance(images, EncoderResult) \
            else self.encode_images(images, batch_size=batch_size)
        return self._sharded_logits(
            feats, None if class_prompts is None else labels, batch_size)

    def predict(self, images, class_prompts: Optional[Sequence[str]] = None,
                num_samples: int = 0, seed: int = 0,
                batch_size: int = 256) -> torch.Tensor:
        """Calibrated class probabilities [B, C] on the model's device:
        probit approximation when num_samples=0
        (ref:scripts/zeroshot.py:119-120), MC softmax otherwise
        (ref:bayesvlm/vlm.py:80-103). A call that matches the serving
        ladder (compile_serving) runs its program instead."""
        fast = self._predict_fast(images, num_samples, class_prompts)
        if fast is not None:
            self.replays += 1
            return fast
        self.eager_calls += 1
        pl = self.logits(images, class_prompts, batch_size=batch_size)
        return pl.softmax(num_samples=num_samples, seed=seed)
