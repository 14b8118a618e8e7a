"""Convert a Hessian artifact directory between the reference `.pt` lane
and the port's checkpoint lane, the counterpart of the JAX package's
`scripts/convert_artifacts.py`: the command line of
`io/dcp_ckpt.{hessians_to_dcp,dcp_to_hessians}`. The flags keep the JAX
spellings, so `--to orbax` names the port's checkpoint lane, a
torch.distributed.checkpoint under `factors_dcp/`:

    # .pt directory -> add factors_dcp/ beside the .pt files
    python -m bayesvlm_tpu_torch.convert_artifacts --la_dir hessians/X --to orbax

    # factors_dcp/ -> (re)write the reference .pt files in place
    python -m bayesvlm_tpu_torch.convert_artifacts --la_dir runs/X --to pt

    # into another directory (the prior-precision JSON copied too)
    python -m bayesvlm_tpu_torch.convert_artifacts --la_dir A --to orbax --out B

Both directions are lossless fp32, and `artifacts.load_hessians` reads
either layout (it falls back to factors_dcp/ when the .pt files are
absent). Pure file work on the CPU: no card is touched.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Optional


def main(la_dir: str, to: str, out: Optional[str] = None) -> Path:
    from bayesvlm_tpu_torch.io.dcp_ckpt import dcp_to_hessians, hessians_to_dcp

    if to not in ("orbax", "pt"):
        raise ValueError(f"--to must be 'orbax' or 'pt', got {to!r}")
    dest = hessians_to_dcp(la_dir, out) if to == "orbax" else dcp_to_hessians(la_dir, out)
    print(f"wrote {to} artifacts: {dest}")
    return dest


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument(
        "--la_dir", required=True,
        help="source artifact directory (reference .pt layout for --to orbax; a "
             "factors_dcp/ layout for --to pt)")
    parser.add_argument("--to", required=True, choices=("orbax", "pt"),
                        help="target lane ('orbax': the port's factors_dcp/)")
    parser.add_argument(
        "--out", default=None,
        help="optional destination directory (default: convert in place, both "
             "lanes readable side by side)")
    return parser


if __name__ == "__main__":
    args = _parser().parse_args()
    main(args.la_dir, args.to, args.out)
