"""Mode 'train': closed-loop epochs of the port's train segment, as
`main.run()` drives it. Each epoch runs its steps over one permutation of
the training split and the per-epoch monitoring eval on a test batch;
the host reads the metrics every `fetch_every` epochs, as `main.run()`
flushes them.

Traffic keys: batch, n_train, n_test, L, check_steps (the first steps
the reference follows), fetch_every, trace_epochs (epochs in a traced
slice), max_epochs (epochs drawn for the window).
"""

import functools
import time

import torch

from portbench.harness import compare, data, program, trace, weights
from portbench.reference import model as ref


class Mode:
    """Set-up (data, model, the first steps the reference follows, one
    warm-up epoch) in the constructor; `window(seconds)` measures;
    `program_numbers()` and `readings()` judge once the window has
    closed."""

    def __init__(self, ctx):
        self.ctx = ctx
        cfg, tr, dev = ctx.cfg, ctx.traffic, ctx.device
        self.B, self.L, self.T = tr['batch'], tr['L'], cfg['T']
        n_tr, n_te = tr['n_train'], tr['n_test']
        if n_tr % self.B:
            raise ValueError('the batch must divide the training split')
        self.I = n_tr // self.B
        g = data.generator(ctx.seed, data.DATA, dev)
        X = data.rotating_sequences(n_tr + n_te, self.T, g, dev)
        self.Xtr, self.Xte = X[:n_tr], X[n_tr:]
        E = tr['max_epochs']
        self.heads = data.permutations(E, n_tr, g, dev).reshape(
            E, self.I, self.B)
        self.test_idx = data.permutations(E, n_te, g, dev)[
            :, :min(self.B, n_te)]
        ctx.phase('data')
        self.state0 = weights.initial_state(
            cfg, ctx.root, data.generator(ctx.seed, data.WEIGHTS, dev), dev)
        self.st = program.train_state(cfg, ctx.root, self.state0, dev)
        self.segment = program.train_segment(cfg)
        ctx.phase('model')
        self.gen = data.generator(ctx.seed, data.NOISE, dev)
        self.noise_state = self.gen.get_state()
        self._first_steps(tr['check_steps'])
        self.epoch = 1
        self._epoch()                        # the steady epoch's shapes
        if ctx.trace:                        # the profiler's own start-up
            prof = trace.profiler(dev)
            prof.start()
            self._epoch()
            data.sync(dev)
            prof.stop()
        data.sync(dev)
        ctx.phase('warm-up')

    def _epoch(self):
        """One epoch through the train segment: (its per-step losses on
        the device, the host's seconds in the call)."""
        e = self.epoch
        t = time.perf_counter()
        m, _ = self.segment(self.st, self.Xtr, self.heads[e:e + 1], None,
                            self.Xte, self.test_idx[e:e + 1], self.L,
                            self.gen)
        self.epoch += 1
        return m['loss'][0], time.perf_counter() - t

    def _first_steps(self, k):
        """Epoch 0: the steps the reference follows, with Adam's first
        moments after the first and the leaves after the k-th."""
        if k > self.I:
            raise ValueError('check_steps exceeds the steps of an epoch')
        snaps, n = {}, [0]

        def on_step(e):
            n[0] += 1
            if n[0] == 1:
                snaps['mu1'] = {k_: t.detach().clone() for k_, t in
                                program.leaves(self.st)[1].items()}
            if n[0] == k:
                snaps['p3'] = {k_: t.detach().clone() for k_, t in
                               program.leaves(self.st)[0].items()}

        m, _ = self.segment(self.st, self.Xtr, self.heads[:1], None,
                            self.Xte, self.test_idx[:1], self.L, self.gen,
                            on_step=on_step)
        snaps['steps'] = [{key: float(m[key][0, i]) for key in
                           ('loss', 'nll', 'kl_reg', 'kl_u')}
                          for i in range(k)]
        self.first = snaps

    def window(self, seconds):
        """Epochs until `seconds` have passed, then a synchronize. With a
        trace, `trace_epochs` epochs at the window's middle are traced.
        Returns the run's raw facts: counts, times, the work of one call
        by its shapes, and the trace."""
        ctx, tr, dev = self.ctx, self.ctx.traffic, self.ctx.device
        call_s, losses, pending = [], [], []
        traced, pre = None, (None, None)
        fetch = tr['fetch_every']
        e0 = self.epoch
        t0 = time.perf_counter()
        while True:
            if self.epoch >= tr['max_epochs']:
                raise RuntimeError('the window outran the epochs drawn')
            if ctx.trace and traced is None and \
                    time.perf_counter() - t0 >= seconds / 2:
                # the window's middle; it does not close before this
                data.sync(dev)
                pre = (self.epoch - e0, time.perf_counter() - t0)
                prof = trace.profiler(dev)
                prof.start()
                ts = time.perf_counter()
                for _ in range(tr['trace_epochs']):
                    pending.append(self._epoch()[0])
                data.sync(dev)
                span = time.perf_counter() - ts
                prof.stop()
                traced = trace.read(prof, span, tr['trace_epochs'] * self.I,
                                    tr['trace_epochs'])
            else:
                loss, dt = self._epoch()
                pending.append(loss)
                call_s.append(dt)
            if len(pending) >= fetch:
                losses.append(torch.cat(pending).cpu())
                pending = []
            if time.perf_counter() - t0 >= seconds and (
                    traced is not None or not ctx.trace):
                break
        data.sync(dev)
        wall = time.perf_counter() - t0
        if pending:
            losses.append(torch.cat(pending).cpu())
        loss = torch.cat(losses)
        ok = int(torch.isfinite(loss).sum())
        work = [{'kind': 'train_step', 'L': self.L, 'N': self.B,
                 'T': self.T, 'count': self.I},
                {'kind': 'forward', 'L': 1, 'N': self.test_idx.shape[1],
                 'T': self.T, 'count': 1}]
        return dict(mode='train', cfg=ctx.cfg, window_s=wall,
                    attempted=loss.numel(), failed=loss.numel() - ok,
                    seqs=ok * self.B, call_s=call_s, units_per_call=self.I,
                    work=work, trace=traced, calls_before_trace=pre[0],
                    wall_before_trace_s=pre[1])

    def free(self):
        del self.st, self.segment

    def check(self, prec='f32', half=False):
        """The reference's first steps from the same state, batches and
        noise; returns {'steps', 'p3'}. `half` plants a fault: each step
        takes the first half of its batch alone."""
        ctx, dev = self.ctx, self.ctx.device
        gen = torch.Generator(device=dev)
        gen.set_state(self.noise_state)
        k = ctx.traffic['check_steps']
        batches = [self.Xtr[self.heads[0, i]] for i in range(k)]
        noises = [ref.draw_noise(ctx.cfg, self.B, self.L, gen, dev)
                  for _ in range(k)]
        if half:
            n = self.B // 2
            batches = [b[:n] for b in batches]
            noises = [dict(z, z0=z['z0'][:n]) for z in noises]
        steps, P3 = ref.train_steps(
            ctx.cfg, self.state0['params'], self.state0['adam'], batches,
            noises, self.L, float(ctx.cfg['Ndata']), ctx.cfg['lr'],
            ref.Ops(prec))
        return {'steps': steps, 'p3': P3}

    @functools.cached_property
    def reference(self):
        """The float32 reference's first steps."""
        return self.check('f32')

    def numbers(self, got):
        """The compared numbers of `got` ({'steps', 'mu1', 'p3'}, the
        program's or a control's) against the float32 reference."""
        return compare.train_numbers(got, self.reference,
                                     self.state0['params'],
                                     self.state0['adam']['mu'])

    def program_numbers(self):
        return self.numbers(self.first)

    def _as_program(self, c):
        mu0 = self.state0['adam']['mu']
        return {'steps': c['steps'], 'p3': c['p3'],
                'mu1': {n: (1 - 0.9) * g + 0.9 * mu0[n]
                        for n, g in c['steps'][0]['grads'].items()}}

    def readings(self):
        """The numbers that set the limits besides the program's: the
        control (the reference with TF32 products in the program's
        place) and the reference with half of each batch left out."""
        return {'control': self.numbers(self._as_program(self.check('tf32'))),
                'half_batch': self.numbers(self._as_program(
                    self.check('f32', half=True)))}
