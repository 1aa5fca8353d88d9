"""Reproduce on the card the DF training defect that the DF cells avoid
by resuming from the trained checkpoint: from a random init, a train
step whose divergence-free gram is not positive definite in float32
gives a NaN loss, the NaN guard discards it, the parameters stay as they
were, and so every later step meets the same gram.

    python3 portbench/probes/df_defect.py --seeds 1 2 ... [--steps 600]

Per seed: the port's train step (`make_train_step`, the step of
`main.run()`) at batch 20 and L=5 over the 360-sequence synthetic split,
from the benchmark's random init of the df-q6 configuration; before
each step the float32 `cholesky_ex` of the gram (the reference's
formula, on the step's parameters). Prints one JSON line per seed: the
first discarded step, the steps after it and how many of them were
discarded too, and `cholesky_ex`'s info at that step.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import torch  # noqa: E402

from portbench.harness import data, program, spec, weights  # noqa: E402
from portbench.reference import model as ref  # noqa: E402


def gram_info(st, ops):
    """`cholesky_ex`'s info of the DF gram of the state's GP leaves."""
    gp = st.gp
    ls = ref.softplus(gp.kernel.unconstrained_lengthscales.detach())
    var = ref.softplus(gp.kernel.unconstrained_variance.detach())
    Z = gp.inducing_loc.detach()
    K = ref._df_gram(ops, ls, var, Z, Z)
    K = K + torch.eye(K.shape[0], device=K.device) * ref.JITTER
    return torch.linalg.cholesky_ex((K + K.T) / 2)[1]


def run_seed(seed, steps, batch, L, cfg, dev):
    from vae_gp_ode_tpu_torch.training.trainer import make_train_step
    n = cfg['Ndata']
    g = data.generator(seed, 1, dev)
    X = data.rotating_sequences(n, cfg['T'], g, dev)
    per_epoch = n // batch
    epochs = -(-steps // per_epoch)
    heads = data.permutations(epochs, n, g, dev)
    state0 = weights.random_state(cfg, data.generator(seed, 2, dev), dev)
    st = program.train_state(cfg, spec.ROOT, state0, dev)
    step = make_train_step(n, eps_guard=cfg['eps_guard'])
    gen = data.generator(seed, 3, dev)
    ops = ref.Ops('f32')
    losses, infos = [], []
    for s in range(steps):
        e, i = divmod(s, per_epoch)
        infos.append(gram_info(st, ops))
        m = step(st, X[heads[e, i * batch:(i + 1) * batch]], L, gen)
        losses.append(m['loss'])
    loss = torch.stack(losses).cpu()
    info = torch.stack(infos).cpu()
    bad = (~torch.isfinite(loss)).nonzero().flatten().tolist()
    first = bad[0] if bad else None
    return {'seed': seed, 'steps': steps,
            'first_discarded': first,
            'steps_after': None if first is None else steps - first - 1,
            'discarded_after': None if first is None else len(bad) - 1,
            'cholesky_info_at_first': None if first is None
            else int(info[first]),
            'steps_with_indefinite_gram': int((info != 0).sum()),
            'final_loss': float(loss[-1])}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--seeds', type=int, nargs='+', required=True)
    p.add_argument('--steps', type=int, default=600)
    p.add_argument('--batch', type=int, default=20)
    p.add_argument('--L', type=int, default=5)
    p.add_argument('--device', default='cuda')
    a = p.parse_args(argv)
    b = spec.benchmark()
    cfg = dict(spec.config(b, 'df-q6'), weights='seed')
    dev = torch.device(a.device)
    program.load()
    for seed in a.seeds:
        print(json.dumps(run_seed(seed, a.steps, a.batch, a.L, cfg, dev)),
              flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
