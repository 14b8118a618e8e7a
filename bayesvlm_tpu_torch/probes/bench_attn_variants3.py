"""Attention-schedule probe 3 on the card, the port of
scripts/dev/bench_attn_variants3.py: the one-block kernel #1 (one batch
row a block) against

  v6  two batch rows a block (half the blocks: the per-block overhead),
      #1's function: in bf16 #1's tensor-core body walking both rows in
      turn, its K/V ring running on across them
      (csrc/attention_variants.cu note (c))

at B=80, T=257, H=16, Dh=64, bf16. An odd batch raises (the script's
grid B // 2 would leave the last row unwritten).
Run: python -m bayesvlm_tpu_torch.probes.bench_attn_variants3
"""

from __future__ import annotations

import sys

from bayesvlm_tpu_torch import probes
from bayesvlm_tpu_torch.models.attention import fused_attention_reference
from bayesvlm_tpu_torch.probes.attention_variants import attention_group_rows

VARIANTS = {
    "v6": probes.Variant(attention_group_rows, fused_attention_reference,
                         "attention_group_rows", "2 rows a block"),
}

parse_args, run, report, main = probes.entry_points(VARIANTS, __doc__)


if __name__ == "__main__":
    sys.exit(main())
