"""The factor-checkpoint lane on `torch.distributed.checkpoint` (DCP), the
counterpart of the JAX package's orbax lane (`bayesvlm_tpu/io/orbax_ckpt.py:49-408`).

The reference persists every artifact with `torch.save`
(ref:bayesvlm/hessians.py:137-167,203-217); `io/artifacts.py` keeps that
contract. This module adds the production lane beside it:

- sharded saves: each rank writes its own rows of a row-sharded tensor
  (a DTensor with `Shard(0)` over a port mesh), no gather;
- restore-with-sharding: `load_pytree(..., shardings=mesh)` gives each
  rank only its rows. DCP reshards on load, so a checkpoint saved at one
  world size loads at another (JAX's cross-topology fallback,
  `orbax_ckpt.py:149-175`, has no counterpart);
- background saves (`async_save_pytree`), step-managed retention
  (`StepCheckpoints`), and the conversion to and from the `.pt` Hessian
  directory (`hessians_to_dcp` / `dcp_to_hessians`).

A tree is a nested dict of tensors (numpy arrays become tensors) and
plain Python numbers or strings. A checkpoint is a DCP directory,
written under a temporary name and renamed into place once complete, so
a reader never sees a torn one. Within one Hessian directory the four
factors live under `<la_dir>/factors_dcp/`; the prior-precision JSON stays
the shared sidecar, so `artifacts.load_info` reads either lane. JAX's
`factors_orbax/` (an orbax checkpoint) is not readable here.

Under an initialised process group of more than one rank, `save_pytree`
and `async_save_pytree` are collective (every rank calls them; a tensor
all ranks hold alike is written once) unless `no_dist=True`, which writes
this process's tree alone (the Stage-1 CLI's rank 0 does so). A load is
collective only when it asks for DTensors (`shardings` / a DTensor `like`).
"""

from __future__ import annotations

import contextlib
import os
import shutil
import warnings
from collections import namedtuple
from pathlib import Path
from typing import Any, Callable, Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist
import torch.distributed.checkpoint as dcp

PathLike = Union[str, Path]
FACTORS_SUBDIR = "factors_dcp"
LeafMetadata = namedtuple("LeafMetadata", "shape dtype")  # (None, None): not a tensor


def _abspath(path: PathLike) -> Path:
    return Path(path).expanduser().resolve()


@contextlib.contextmanager
def _quiet():
    """DCP warns that it runs without a process group on every no_dist
    call; that is this module's single-process mode, not a fault."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*(process group|torch.distributed).*")
        yield


def _collective(no_dist: bool) -> bool:
    return (not no_dist and dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1)


def _is_primary(collective: bool) -> bool:
    return not collective or dist.get_rank() == 0


def _barrier(collective: bool) -> None:
    if collective:
        dist.barrier()


def _state(tree: Any) -> Any:
    """The tree as DCP takes it: numpy arrays and numpy scalars as tensors."""
    if isinstance(tree, dict):
        bad = [k for k in tree if not isinstance(k, str)]
        if bad:
            raise ValueError(f"tree keys must be strings, got {bad}")
        return {k: _state(v) for k, v in tree.items()}
    if isinstance(tree, (np.ndarray, np.generic)):
        return torch.from_numpy(np.array(tree))
    if isinstance(tree, (torch.Tensor, int, float, bool, str)) or tree is None:
        return tree
    raise TypeError(f"a checkpoint tree holds dicts, tensors, arrays and numbers, "
                    f"not {type(tree).__name__}")


def _begin(path: Path, overwrite: bool, collective: bool) -> Path:
    """The temporary directory a save writes into (made empty)."""
    if path.exists() and not overwrite:
        raise FileExistsError(f"checkpoint {path} exists (overwrite=False)")
    tmp = path.with_name(f".{path.name}.tmp")
    if _is_primary(collective):
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir(parents=True)
    _barrier(collective)
    return tmp


def _finalize(tmp: Path, path: Path, collective: bool) -> None:
    """Rename the finished temporary directory into place."""
    _barrier(collective)
    if _is_primary(collective):
        old = path.with_name(f".{path.name}.old")
        shutil.rmtree(old, ignore_errors=True)
        if path.exists():
            os.replace(path, old)
        os.replace(tmp, path)
        shutil.rmtree(old, ignore_errors=True)
    _barrier(collective)


def save_pytree(path: PathLike, tree: Any, *, overwrite: bool = True,
                no_dist: bool = False) -> None:
    """Save `tree` as a DCP checkpoint at `path` (module docstring)."""
    path = _abspath(path)
    collective = _collective(no_dist)
    tmp = _begin(path, overwrite, collective)
    with _quiet():
        dcp.save(_state(tree), storage_writer=dcp.FileSystemWriter(str(tmp)),
                 no_dist=not collective)
    _finalize(tmp, path, collective)


class AsyncSaveHandle:
    """A background save; `wait()` (or leaving the `with` block) finishes
    it and renames the checkpoint into place. Until then `path` holds the
    previous checkpoint, if any."""

    def __init__(self, future, finish: Callable[[], None]):
        self._future, self._finish = future, finish
        self._done = False

    def wait(self) -> None:
        if not self._done:
            self._future.result()
            self._finish()
            self._done = True

    def __enter__(self) -> "AsyncSaveHandle":
        return self

    def __exit__(self, *exc) -> None:
        self.wait()


def async_save_pytree(path: PathLike, tree: Any, *, overwrite: bool = True,
                      no_dist: bool = False) -> AsyncSaveHandle:
    """Start a save in a background thread and return its handle. The
    tensors are copied to host memory before this returns, so the caller
    may overwrite them at once. Collective as `save_pytree`; under a
    process group DCP's background thread needs a CPU (gloo) backend, and
    the ranks issue no other collective on it until `wait()`."""
    path = _abspath(path)
    collective = _collective(no_dist)
    tmp = _begin(path, overwrite, collective)
    with _quiet():
        future = dcp.async_save(_state(tree), storage_writer=dcp.FileSystemWriter(str(tmp)),
                                no_dist=not collective)
    return AsyncSaveHandle(future, lambda: _finalize(tmp, path, collective))


def _unflatten(flat: dict, planner_data: dict) -> dict:
    """DCP's flat keys back into nested dicts (DCP's planner records each
    key's path)."""
    out: dict = {}
    for key, value in flat.items():
        node = out
        *parents, leaf = planner_data.get(key, (key,))
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return out


def checkpoint_metadata(path: PathLike) -> dict:
    """The stored tree with a LeafMetadata(shape, dtype) a tensor (shape
    and dtype None for a number or a string), read from the checkpoint's
    metadata alone: no tensor data is read."""
    from torch.distributed.checkpoint.metadata import TensorStorageMetadata

    md = dcp.FileSystemReader(str(_abspath(path))).read_metadata()
    flat = {k: LeafMetadata(tuple(m.size), m.properties.dtype)
            if isinstance(m, TensorStorageMetadata) else LeafMetadata(None, None)
            for k, m in md.state_dict_metadata.items()}
    return _unflatten(flat, md.planner_data or {})


ShardingLike = Union[Any, dict, Callable[[LeafMetadata], Any]]


def _row_sharded(meta: LeafMetadata, mesh):
    """An empty DTensor of meta's shape with its rows split over the
    (1-D) mesh, Shard(0): the restore target of one leaf."""
    from torch.distributed.tensor import Shard, empty

    return empty(*meta.shape, dtype=meta.dtype, device_mesh=mesh, placements=[Shard(0)])


def _template(meta: Any, shardings: Optional[ShardingLike]) -> Any:
    """The restore target from the stored metadata: empty CPU tensors, or
    row-sharded DTensors where `shardings` (one mesh for every tensor of
    one dim or more, a dict of meshes or None matching the tree, or a
    LeafMetadata -> mesh-or-None callable) asks for them."""
    if isinstance(meta, dict):
        return {k: _template(v, shardings.get(k) if isinstance(shardings, dict)
                             else shardings) for k, v in meta.items()}
    if meta.dtype is None:
        return None  # a number or a string: DCP fills it in
    mesh = shardings(meta) if callable(shardings) else shardings
    if mesh is None or len(meta.shape) == 0:  # scalars restore replicated
        return torch.empty(meta.shape, dtype=meta.dtype)
    return _row_sharded(meta, mesh)


def _has_dtensor(tree: Any) -> bool:
    from torch.distributed.tensor import DTensor

    if isinstance(tree, dict):
        return any(_has_dtensor(v) for v in tree.values())
    return isinstance(tree, DTensor)


def _like_template(like: Any) -> Any:
    if isinstance(like, dict):
        return {k: _like_template(v) for k, v in like.items()}
    return torch.empty_like(like) if isinstance(like, torch.Tensor) else None


def load_pytree(path: PathLike, *, like: Any = None,
                shardings: Optional[ShardingLike] = None) -> Any:
    """Restore a `save_pytree` checkpoint. `like`: a tree whose tensors
    (or DTensors) give each leaf's dtype, device and layout. `shardings`:
    row-shard the tensors over a port mesh (module docstring); each rank
    then reads only its rows and gets DTensors (`.to_local()` its rows).
    With neither, every tensor restores whole on the CPU with its stored
    shape and dtype."""
    path = _abspath(path)
    target = (_like_template(like) if like is not None
              else _template(checkpoint_metadata(path), shardings))
    collective = _has_dtensor(target)
    with _quiet():
        dcp.load(target, storage_reader=dcp.FileSystemReader(str(path)),
                 no_dist=not collective)
    return target


class StepCheckpoints:
    """Keep-latest-N step checkpoints, `<directory>/<step>/`, each renamed
    into place once complete. Saves run in the background by default;
    `wait` / `close` finish them (and drop the steps past `max_to_keep`).
    Use as a context manager in long-running loops."""

    def __init__(self, directory: PathLike, *, max_to_keep: Optional[int] = 3):
        self.directory = _abspath(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep
        self._pending: list = []

    def save(self, step: int, tree: Any, *, wait: bool = False) -> None:
        self._pending.append(async_save_pytree(self.directory / str(int(step)), tree))
        if wait:
            self.wait()

    def restore(self, step: Optional[int] = None, *, like: Any = None,
                shardings: Optional[ShardingLike] = None) -> Any:
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no step checkpoints under {self.directory}")
        return load_pytree(self.directory / str(int(step)), like=like,
                           shardings=shardings)

    def all_steps(self) -> Sequence[int]:
        return sorted(int(p.name) for p in self.directory.iterdir()
                      if p.is_dir() and p.name.isdigit())

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def wait(self) -> None:
        while self._pending:
            self._pending.pop(0).wait()
        if self.max_to_keep is not None and _is_primary(_collective(False)):
            for step in self.all_steps()[:-self.max_to_keep or None]:
                remove_checkpoint(self.directory / str(step))

    def close(self) -> None:
        self.wait()

    def __enter__(self) -> "StepCheckpoints":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# -- the Hessian directory's factors (.pt <-> DCP) ------------------------------


def save_hessians_dcp(la_dir: PathLike, A_img, B_img, A_txt, B_txt, *,
                      overwrite: bool = True) -> Path:
    """Write the four raw K-FAC factors as one fp32 checkpoint under
    `<la_dir>/factors_dcp`, from this process alone. The prior-precision
    JSON stays the shared sidecar (`artifacts.save_prior_precision`)."""
    la_dir = _abspath(la_dir)
    la_dir.mkdir(parents=True, exist_ok=True)
    tree = {name: torch.as_tensor(F).detach().to("cpu", torch.float32).contiguous()
            for name, F in (("A_img", A_img), ("B_img", B_img), ("A_txt", A_txt),
                            ("B_txt", B_txt))}
    out = la_dir / FACTORS_SUBDIR
    save_pytree(out, tree, overwrite=overwrite, no_dist=True)
    return out


def load_hessians_dcp(la_dir: PathLike, tag: str, *,
                      shardings: Optional[ShardingLike] = None):
    """(A, B) of one direction from `<la_dir>/factors_dcp` (fp32, as
    `artifacts.load_hessians`); with `shardings`, row-sharded DTensors."""
    if tag not in ("img", "txt"):
        raise ValueError(f"tag must be 'img' or 'txt', got {tag!r}")
    tree = load_pytree(_abspath(la_dir) / FACTORS_SUBDIR, shardings=shardings)
    return tree[f"A_{tag}"], tree[f"B_{tag}"]


def has_dcp_factors(la_dir: PathLike) -> bool:
    return (_abspath(la_dir) / FACTORS_SUBDIR).exists()


def _copy_info(src: Path, dst: Path) -> None:
    from bayesvlm_tpu_torch.io.artifacts import load_info, save_prior_precision

    info = load_info(src)
    save_prior_precision(dst, info["lambda_img"], info["n_img"], info["lambda_txt"],
                         info["n_txt"])


def hessians_to_dcp(la_dir: PathLike, out_dir: Optional[PathLike] = None) -> Path:
    """A `.pt` Hessian directory's factors as `factors_dcp/` in `out_dir`
    (default `la_dir`: both lanes side by side); the prior-precision JSON
    is copied when `out_dir` is another directory."""
    from bayesvlm_tpu_torch.io.artifacts import load_hessians

    la_dir = _abspath(la_dir)
    out_dir = la_dir if out_dir is None else _abspath(out_dir)
    A_img, B_img = load_hessians(la_dir, "img")
    A_txt, B_txt = load_hessians(la_dir, "txt")
    out = save_hessians_dcp(out_dir, A_img, B_img, A_txt, B_txt)
    if out_dir != la_dir:
        _copy_info(la_dir, out_dir)
    return out


def dcp_to_hessians(ckpt_dir: PathLike, la_dir: Optional[PathLike] = None) -> Path:
    """`factors_dcp/` back to the reference `.pt` files in `la_dir`
    (default `ckpt_dir`), the prior-precision JSON copied when `la_dir` is
    another directory."""
    from bayesvlm_tpu_torch.io.artifacts import save_hessians

    ckpt_dir = _abspath(ckpt_dir)
    la_dir = ckpt_dir if la_dir is None else _abspath(la_dir)
    tree = load_pytree(ckpt_dir / FACTORS_SUBDIR)
    save_hessians(la_dir, tree["A_img"], tree["B_img"], "img")
    save_hessians(la_dir, tree["A_txt"], tree["B_txt"], "txt")
    if la_dir != ckpt_dir:
        _copy_info(ckpt_dir, la_dir)
    return la_dir


def remove_checkpoint(path: PathLike) -> None:
    """Delete a checkpoint directory (idempotent)."""
    path = _abspath(path)
    if path.exists():
        shutil.rmtree(path)
