"""Attention-schedule probe 4 on the card, the port of
scripts/dev/bench_split_attn.py: the one-block kernel #1 against the
split-key schedule #2 (`fused_attention(..., split_key=True)`: the keys
split at 128 * floor(T / 128), the main block walked with no bounds
checks) at B=80, T=257, H=16, Dh=64, bf16. No new kernel: both are
csrc/attention.cu's.
Run: python -m bayesvlm_tpu_torch.probes.bench_split_attn
"""

from __future__ import annotations

import functools
import sys

from bayesvlm_tpu_torch import probes
from bayesvlm_tpu_torch.models.attention import (
    fused_attention,
    fused_attention_reference,
)

VARIANTS = {
    "split-key": probes.Variant(functools.partial(fused_attention, split_key=True),
                                fused_attention_reference, None,
                                "keys split at 128 floor(T/128)"),
}

parse_args, run, report, main = probes.entry_points(VARIANTS, __doc__)


if __name__ == "__main__":
    sys.exit(main())
