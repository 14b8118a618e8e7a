"""Attention-schedule probe 2 on the card, the port of
scripts/dev/bench_attn_variants2.py: the one-block kernel #1 (fp32
scores, one head a block) against

  v4  bf16 scores: the scaled scores rounded to bf16 before an fp32
      softmax (on the TPU half the score block's VMEM); in bf16 #1's
      tensor-core body with that rounding in both sweeps, so the probe
      times what the rounding costs (csrc/attention_variants.cu note (b))
  v5  H/2 heads a block (the script's grid (B, 2)), #1's function: in
      bf16 #1's tensor-core body walking its 8 heads in turn, one 64-row
      query tile and no score tile (csrc/attention_variants.cu note (c))

at B=80, T=257, H=16, Dh=64, bf16.
Run: python -m bayesvlm_tpu_torch.probes.bench_attn_variants2
"""

from __future__ import annotations

import sys

from bayesvlm_tpu_torch import probes
from bayesvlm_tpu_torch.models.attention import fused_attention_reference
from bayesvlm_tpu_torch.probes.attention_variants import (
    attention_group_heads,
    attention_v4,
    attention_v4_reference,
)

VARIANTS = {
    "v4": probes.Variant(attention_v4, attention_v4_reference, "attention_v4",
                         "bf16 scores"),
    "v5": probes.Variant(attention_group_heads, fused_attention_reference,
                         "attention_group_heads", "H/2 heads a block"),
}

parse_args, run, report, main = probes.entry_points(VARIANTS, __doc__)


if __name__ == "__main__":
    sys.exit(main())
