"""Attention-schedule probe 1 on the card, the port of
scripts/dev/bench_attn_variants.py: the one-block kernel #1 against

  v2  the scale folded into q and the normalisation after p . v (one
      division per output element instead of a pass over the score tile)
  v3  v2 without the max subtraction (an unsafe-numerics probe: it
      measures what the max pass costs, it is no candidate)

at B=80, T=257, H=16, Dh=64, bf16 (csrc/attention_variants.cu, kernel
template (a)). Run: python -m bayesvlm_tpu_torch.probes.bench_attn_variants
"""

from __future__ import annotations

import functools
import sys

from bayesvlm_tpu_torch import probes
from bayesvlm_tpu_torch.probes.attention_variants import (
    attention_v2,
    attention_v2_reference,
)

VARIANTS = {
    "v2": probes.Variant(attention_v2, attention_v2_reference, "attention_v2",
                         "scale-in-q + normalize-after-pv"),
    "v3": probes.Variant(functools.partial(attention_v2, subtract_max=False),
                         functools.partial(attention_v2_reference, subtract_max=False),
                         "attention_v3", "v2 + no max subtract, probe only"),
}

parse_args, run, report, main = probes.entry_points(VARIANTS, __doc__)


if __name__ == "__main__":
    sys.exit(main())
