#!/usr/bin/env bash
# The training CLI over several cards against one: `main.py --Nepoch 2`
# at its defaults on one GPU, then the same flags with --data_parallel
# True under torchrun over every GPU of the machine (NCCL, one rank a
# card); prints the cards, both runs' wall times (process start-up
# included), the backend, the first and last step's ELBO of each and
# their epoch lines. From the repository root:
#
#   bash dp_cards_check.sh            # on a machine with 2 or more GPUs
#
# The runs and their logs go under build/dp_cards_check/.
set -e
mkdir -p build/dp_cards_check
rm -rf build/dp_cards_check/*_*
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
n=$(nvidia-smi --query-gpu=name --format=csv,noheader | wc -l)
t0=$(date +%s.%N)
python -m vae_gp_ode_tpu_torch.main --Nepoch 2 \
    --save build/dp_cards_check/one > build/dp_cards_check/one.log 2>&1
t1=$(date +%s.%N)
torchrun --standalone --nproc_per_node "$n" -m vae_gp_ode_tpu_torch.main \
    --data_parallel True --Nepoch 2 \
    --save build/dp_cards_check/dp > build/dp_cards_check/ranks.log 2>&1
t2=$(date +%s.%N)
python -c "print('single-device run %.1f s, $n ranks %.1f s (process start-up included)' % ($t1 - $t0, $t2 - $t1))"
grep -m1 "Data-parallel over" build/dp_cards_check/ranks.log
python - <<'PY'
import glob
import numpy as np
one = np.load(glob.glob('build/dp_cards_check/one_*/elbo.npy')[0])
dp = np.load(glob.glob('build/dp_cards_check/dp_*/elbo.npy')[0])
assert one.shape == dp.shape and np.isfinite(dp).all(), (one.shape, dp.shape)
print('first-step ELBO: one card %.4f, ranks %.4f (rel %.2e); last step '
      '%.4f, %.4f' % (one[0], dp[0], abs(one[0] - dp[0]) / abs(one[0]),
                      one[-1], dp[-1]))
PY
grep "Epoch:" build/dp_cards_check/one.log build/dp_cards_check/ranks.log
