#!/usr/bin/env bash
# Serving A/B of two checkouts of the PyTorch port on one GPU, in turns
# (A, B, B, A), so both run on the same card in the same call:
#
#     scripts/torch_ab_serving.sh DIR_A DIR_B
#
# Each turn runs `chip_smoke.check_serving` of that checkout twice in a
# fresh process (full width, seeded weights: a warm-up, one B=16 x 400-frame
# call, two B=1 calls) and prints its serving and single-request lines,
# each prefixed with the checkout's directory.
set -euo pipefail
[ $# -eq 2 ] || { echo "usage: $0 DIR_A DIR_B" >&2; exit 2; }

run() {
  (cd "$1" && python - <<'PY'
import torch

import chip_smoke as cs

try:
    from ns2vc_tpu_torch.config import Config
except ImportError:   # checkouts from before the port had its own config
    from ns2vc_tpu.config import Config
from ns2vc_tpu_torch.convert import init_params, init_vocos_params

cs.CARD = cs.card_line()
cfg = Config()
g = torch.Generator().manual_seed(0)
sd = init_params(cfg, g)
vsd = init_vocos_params(g, hop_length=cfg.data.hop_length)
for _ in range(2):
    cs.check_serving(cfg, sd, vsd, torch.device("cuda:0"))
PY
  ) 2>&1 | grep -E "^(serving|single|FAIL)" | sed "s|^|$1: |"
}

run "$1"
run "$2"
run "$2"
run "$1"
