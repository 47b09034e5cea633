"""The lm_embed kind: a language model embeds each test batch inside
`ValuationSession.update`, and the pooled features are valued by
KNN-Shapley against a train set embedded offline.

Inputs, from `--seed`. The model's weights: `reference.jamba.draw_weights`
at the configuration's sizes, drawn on the card in f32 and rounded to
bf16, laid into the port's tree (`models.params.params_from_flat`). The
train features: the blob kind's `Blobs` at d = hidden_size, drawn on the
card; they stand for reviews embedded offline (`assumed`). Test batch i:
`test_batch` reviews of log-normal lengths (the mix's mean, sigma of the
log, clip), their labels uniform over the classes (both from host
streams, so that no draw waits on the card), and their token ids
uniform over the vocabulary on the card, right-padded with -1 to the
batch's longest. The lengths come from the mix's `lengths_seed`, the
same sample of the distribution in every run, because a step's work
follows its longest review: with lengths from the run's seed, the
window's mean padded length, and with it the rate and the peak, would
differ by some percent from seed to seed. Labels and token ids come
from the run's seed.

Driver. One client, at most `in_flight` steps queued (as the blob kind's
`SessionLoop`), each `ValuationSession.update(ids, labels)` with the
session's `embed_fn` = `Model.embed` (lengths from the padding) on the
test batches only (`embed_train=False`). Each step's embeddings, as the
step consumed them, are copied into a preallocated buffer (NaN where a
row was never embedded), and the point state after each step into
another (n floats a step); both copies are the benchmark's and run
outside the program's spans. Traced, the program's counters are read
after the window into the records (`counters`), beside the window's
real tokens (`window_tokens`) and the sum of L (L + 1) over its reviews
(`window_pairs`), which the cost readers take.

Check, after the program's result is taken and the program freed, in two
stages:

  * embedding: the plain reference (`reference/jamba.py`, f32) embeds,
    from the seed alone (weights and token ids drawn again), a seeded
    sample of `sample_reviews` folded reviews and the longest folded one;
    `embed_median` and `embed_max` are the median and the largest
    ||recorded - ref|| / ||ref|| per review (a review never embedded
    reads inf);
  * values: `KnnShapleyReference` (f64 distances) over the train set
    drawn again, fed the recorded embeddings and the labels drawn again
    of `value_steps` seeded steps; for each step, ||increment - ref|| /
    ||ref|| of the program's own increment (its state after the step
    less its state before, over the step's points) and the reference's
    values of the step's points; `values_median` is the median over the
    steps. One near-tie flipped at a high rank can make one step's gap
    the whole number (f32 distances flip some on every card: the same
    holds for sti's `rows_median`), and the median of the steps
    leaves it out while a precision lost on every distance, TF32's,
    moves every step. `fold_gap`: the test points the program folded
    less those the driver folded.

This departs from the README's "never from anything the program holds"
in one place: the values stage ranks the program's recorded embeddings.
Two reasons: bf16 embeddings (the configuration's precision) sit at
~1e-2 of the f32 reference's, which flips near-tie ranks among 650,000
train points, so values from the reference's own embeddings could not
be compared tightly; and the embedding stage holds those very embeddings
to the reference. The values stage samples steps because f64 distances
to 650,000 x 4096 train features take ~3 s a step on the card, and the
program's increments are exact to ~1e-6 (a difference of two f32 sums).

`control`, the reference computed a precision below the configuration's
in the program's place: the values stage with TF32 distances (below f32),
and the embedding with every activation at 3 bits of mantissa (float8
e4m3's, below bf16's 7; `reference.jamba.round_mantissa`).

On the CPU (the tests) the model is cut to `CPU_SIZES` (d 64, 4 heads of
16 and 2 KV heads, SwiGLU 96, 4 experts, dt_rank 8, vocab 512; 8 layers
and every other size as the configuration's) and reviews to lengths in
[CPU_LENGTH_MIN, CPU_LENGTH_MAX] = [16, 64] around a mean of
CPU_LENGTH_MEAN = 32, and the embedding stage samples CPU_SAMPLE_REVIEWS
= 8 reviews and the longest (the reference runs thousands of small ops a
review, which a test run of many processes on few cores makes slow); on
the card the configuration's sizes run, nothing else.
"""

from __future__ import annotations

import collections
import contextlib
import gc
import math
import statistics
import time

import torch

from portbench.kinds.blobs import Blobs, _event, _sync, rel_l2
from portbench.reference import KnnShapleyReference
from portbench.reference import jamba as ref_jamba
from portbench.traffic import generator, stream_seed

TEST0 = 1 << 20          # batch i: host stream TEST0 + 2i, card TEST0 + 2i + 1
SAMPLE_STREAM = 5
STEP_STREAM = 6
CPU_SIZES = {"d_model": 64, "heads": 4, "kv_heads": 2, "head_dim": 16,
             "d_ff": 96, "experts": 4, "dt_rank": 8, "vocab": 512}
CPU_LENGTH_MEAN, CPU_LENGTH_MIN, CPU_LENGTH_MAX = 32, 16, 64
CPU_SAMPLE_REVIEWS = 8
CAPACITY = 256           # steps the buffers hold before they grow
CONTROL_ACT_BITS = 3     # the control's activations: float8 e4m3's mantissa


def sizes_of(cfg: dict, dev: torch.device) -> dict:
    """The reference's sizes from the configuration's keys (the
    published names), cut to `CPU_SIZES` on the CPU."""
    s = {"d_model": cfg["hidden_size"], "layers": cfg["num_hidden_layers"],
         "heads": cfg["num_attention_heads"],
         "kv_heads": cfg["num_key_value_heads"],
         "head_dim": cfg["hidden_size"] // cfg["num_attention_heads"],
         "d_ff": cfg["intermediate_size"], "vocab": cfg["vocab_size"],
         "experts": cfg["num_experts"], "top_k": cfg["num_experts_per_tok"],
         "d_state": cfg["mamba_d_state"], "d_conv": cfg["mamba_d_conv"],
         "expand": cfg["mamba_expand"], "dt_rank": cfg["mamba_dt_rank"],
         "eps": cfg["rms_norm_eps"], "attn_offset": cfg["attn_layer_offset"],
         "attn_period": cfg["attn_layer_period"],
         "expert_offset": cfg["expert_layer_offset"],
         "expert_period": cfg["expert_layer_period"], "head": False}
    if dev.type == "cpu":
        s.update(CPU_SIZES)
    return s


def port_config(sizes: dict):
    """The port's `jamba2-mini` at `sizes`."""
    from repro_torch.configs.registry import get_config

    return get_config("jamba2-mini").replace(
        num_layers=sizes["layers"], d_model=sizes["d_model"],
        num_heads=sizes["heads"], num_kv_heads=sizes["kv_heads"],
        head_dim=sizes["head_dim"], d_ff=sizes["d_ff"],
        vocab_size=sizes["vocab"], num_experts=sizes["experts"],
        experts_per_token=sizes["top_k"], ssm_state_dim=sizes["d_state"],
        ssm_conv_dim=sizes["d_conv"], ssm_expand=sizes["expand"],
        dt_rank=sizes["dt_rank"], norm_eps=sizes["eps"])


class Reviews:
    """The test batches of the mix, drawn from the seed."""

    def __init__(self, mix: dict, sizes: dict, classes: int, seed: int,
                 dev: torch.device):
        self.tb, self.seed, self.dev = int(mix["test_batch"]), seed, dev
        self.vocab, self.classes = sizes["vocab"], classes
        if dev.type == "cpu":
            mean, lo, hi = CPU_LENGTH_MEAN, CPU_LENGTH_MIN, CPU_LENGTH_MAX
        else:
            mean, lo, hi = (mix["length_mean"], mix["length_min"],
                            mix["length_max"])
        self.sigma = float(mix["length_sigma_log"])
        self.lengths_seed = int(mix["lengths_seed"])
        self.mu = math.log(mean) - 0.5 * self.sigma ** 2
        self.lo, self.hi = int(lo), int(hi)

    def host(self, i: int):
        """Batch i's (tb,) lengths (from the mix's `lengths_seed`) and (tb,)
        int32 labels (from the run's seed), on the host."""
        gen = torch.Generator().manual_seed(stream_seed(self.lengths_seed,
                                                        TEST0 + 2 * i))
        z = torch.randn((self.tb,), generator=gen, dtype=torch.float64)
        lengths = torch.exp(self.mu + self.sigma * z).round().clamp(
            self.lo, self.hi).to(torch.int64)
        gen = torch.Generator().manual_seed(stream_seed(self.seed,
                                                        TEST0 + 2 * i))
        labels = torch.randint(0, self.classes, (self.tb,), generator=gen,
                               dtype=torch.int32)
        return lengths, labels

    def batch(self, i: int):
        """Batch i: (tb, L) int64 ids right-padded with -1 (L its longest)
        and (tb,) int32 labels, on the device; nothing waits on it."""
        lengths, labels = self.host(i)
        width = int(lengths.max())
        pin = self.dev.type == "cuda"
        lens = lengths.pin_memory() if pin else lengths
        labs = labels.pin_memory() if pin else labels
        lens = lens.to(self.dev, non_blocking=True)
        labs = labs.to(self.dev, non_blocking=True)
        ids = torch.randint(0, self.vocab, (self.tb, width),
                            generator=generator(self.seed, TEST0 + 2 * i + 1,
                                                self.dev), device=self.dev)
        pad = torch.arange(width, device=self.dev)[None, :] >= lens[:, None]
        return ids.masked_fill_(pad, -1), labs

    def review(self, i: int, r: int) -> torch.Tensor:
        """Review r of batch i: its (length,) ids."""
        ids, _ = self.batch(i)
        return ids[r][ids[r] >= 0]


class Driver:
    """One client folds the mix's review batches through
    `ValuationSession.update`, at most `in_flight` steps queued."""

    def __init__(self, cfg: dict, mix: dict, seed: int, dev: torch.device):
        from repro_torch import ValuationSession
        from repro_torch.models import build_model
        from repro_torch.models.params import params_from_flat

        self.dev, self.seed = dev, seed
        self.sizes = sizes_of(cfg, dev)
        d = self.sizes["d_model"]
        self.tb = int(mix["test_batch"])
        self.in_flight = max(1, int(mix["in_flight"]))
        t0 = time.perf_counter()
        self.model = build_model(port_config(self.sizes))
        self.params = params_from_flat(
            self.model.cfg, ref_jamba.draw_weights(self.sizes, seed, dev))
        _sync(dev)
        t1 = time.perf_counter()
        self.blobs = Blobs(dict(cfg, d=d), seed, dev)
        x, y = self.blobs.train(int(cfg["n"]))
        _sync(dev)
        t2 = time.perf_counter()
        self.reviews = Reviews(mix, self.sizes, int(cfg["classes"]), seed,
                               dev)
        self.records = {"n": int(cfg["n"]), "d": d, "config": cfg,
                        "mix": mix, "sizes": self.sizes}
        self.emb = torch.empty((0, self.tb, d), device=dev)
        self.snaps = torch.empty((0, int(cfg["n"])), device=dev)
        self._grow()
        self.sess = ValuationSession(
            x, y, k=int(cfg["k"]), mode=cfg["method"], test_batch=self.tb,
            fill=cfg["fill"], distance=cfg["distance"],
            embed_fn=self._embed, embed_train=False, device=dev)
        del x, y
        _sync(dev)
        t3 = time.perf_counter()
        self.batches = 0
        self._fold()
        _sync(dev)
        self.phases = {"weights": t1 - t0, "data": t2 - t1,
                       "session": t3 - t2, "warm": time.perf_counter() - t3}

    def _grow(self) -> None:
        """Room for CAPACITY more steps in both buffers, NaN-filled."""
        nan = float("nan")
        self.emb = torch.cat([self.emb, torch.full(
            (CAPACITY,) + tuple(self.emb.shape[1:]), nan, device=self.dev)])
        self.snaps = torch.cat([self.snaps, torch.full(
            (CAPACITY, self.snaps.shape[1]), nan, device=self.dev)])

    def _embed(self, ids: torch.Tensor) -> torch.Tensor:
        """The session's `embed_fn`: `Model.embed` with the lengths of
        the padding; the rows it gives are copied into this step's slot."""
        e = self.model.embed(self.params, {"tokens": ids,
                                           "lengths": (ids >= 0).sum(1)})
        self.emb[self.batches, :e.shape[0]].copy_(e)
        return e

    def _fold(self, span=None) -> None:
        if self.batches >= self.emb.shape[0]:
            self._grow()
        ids, labels = self.reviews.batch(self.batches)
        if span is None:
            self.sess.update(ids, labels)
        else:
            with span("update"):
                self.sess.update(ids, labels)
        self.snaps[self.batches].copy_(self.sess._state[0])
        self.batches += 1

    def window(self, seconds: float, span) -> dict:
        with _one_thread(self.dev):
            return self._window(seconds, span)

    def _window(self, seconds: float, span) -> dict:
        from repro_torch import tracing

        tracing.counters()  # nothing counted before the window
        waits = collections.deque()
        start = self.batches
        t0 = time.perf_counter()
        with span("window"):
            while time.perf_counter() - t0 < seconds:
                if len(waits) >= self.in_flight:
                    with span("sync"):
                        waits.popleft().synchronize()
                self._fold(span)
                ev = _event(self.dev)
                if ev is not None:
                    waits.append(ev)
            with span("sync"):
                _sync(self.dev)
        window_s = time.perf_counter() - t0
        steps = self.batches - start
        lengths = [self.reviews.host(i)[0] for i in range(start,
                                                          self.batches)]
        self.records["counters"] = tracing.counters()
        return {"window_s": window_s, "steps": steps,
                "points": steps * self.tb, "attempted": steps, "failed": 0,
                "rows_per_step": self.tb,
                "window_tokens": float(sum(int(ln.sum()) for ln in lengths)),
                "window_pairs": float(sum(int((ln * (ln + 1)).sum())
                                          for ln in lengths))}

    def answer(self) -> dict:
        """The program's result, then the program freed."""
        res = self.sess.finalize()
        got = {"t": int(res.meta["t"]),
               "emb": self.emb[:self.batches].clone(),
               "snaps": self.snaps[:self.batches].clone()}
        del res, self.sess, self.params, self.model, self.emb, self.snaps
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
        return got


@contextlib.contextmanager
def _one_thread(dev: torch.device):
    """On the CPU, torch on one thread for the block, then as it was: the
    test-size model is thousands of small ops, which threads on cores
    shared by a parallel test run slow many times over."""
    if dev.type != "cpu":
        yield
        return
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(prev)


def _sample(count: int, total: int, seed: int, stream: int) -> list:
    gen = torch.Generator().manual_seed(stream_seed(seed, stream))
    return sorted(torch.randperm(total, generator=gen)[:count].tolist())


def _embedding_stage(driver: Driver, emb: torch.Tensor, sample: int,
                     seed: int, control: bool) -> tuple:
    """(gaps, control gaps or None) of the sampled reviews and the
    longest."""
    tb, dev = driver.tb, driver.dev
    picks = _sample(sample, driver.batches * tb, seed, SAMPLE_STREAM)
    lengths = torch.cat([driver.reviews.host(i)[0]
                         for i in range(driver.batches)])
    longest = int(torch.argmax(lengths))
    if longest not in picks:
        picks.append(longest)
    w = ref_jamba.draw_weights(driver.sizes, seed, dev)
    gaps, ctl = [], []
    for j in picks:
        ids = driver.reviews.review(j // tb, j % tb)
        want = ref_jamba.embed(w, driver.sizes, ids)
        got = emb[j // tb, j % tb]
        gaps.append(math.inf if not bool(torch.isfinite(got).all())
                    else rel_l2(got, want))
        if control:
            low = ref_jamba.embed(w, driver.sizes, ids,
                                  act_bits=CONTROL_ACT_BITS)
            ctl.append(rel_l2(low, want))
    del w
    return gaps, (ctl if control else None)


def _values_stage(cfg: dict, driver: Driver, got: dict, steps: int,
                  seed: int, control: bool) -> tuple:
    """(per-step gaps, the control's or None) over `steps` seeded steps:
    each step's increment of the program's state against the reference's
    values of that step's points."""
    picks = _sample(steps, driver.batches, seed, STEP_STREAM)
    snaps = got["snaps"]
    xr, yr = driver.blobs.train(int(cfg["n"]))
    refs = {}
    for p in (("tf32", "f64") if control else ("f64",)):
        # the TF32 copy first: its rounding's temporaries beside the f32
        # train set alone, not beside the f64 copy too
        refs[p] = KnnShapleyReference(xr, yr, int(cfg["k"]), precision=p)
        if driver.dev.type == "cuda":
            torch.cuda.empty_cache()
    del xr
    gaps, ctl = [], []
    for i in picks:
        inc = snaps[i].to(torch.float64)
        if i:
            inc -= snaps[i - 1].to(torch.float64)
        inc /= driver.tb
        _, labels = driver.reviews.batch(i)
        xb = got["emb"][i].nan_to_num()
        step = {}
        for p, r in refs.items():
            before = r.vec.clone()
            r.add(xb, labels)
            step[p] = (r.vec - before) / driver.tb
        gaps.append(rel_l2(inc, step["f64"]))
        if control:
            ctl.append(rel_l2(step["tf32"], step["f64"]))
    return gaps, (ctl if control else None)


# ------------------------------------------------------------- kind contract
def build(cfg: dict, mix: dict, seed: int, dev: torch.device) -> Driver:
    """Weights and the train set drawn on `dev` from the seed, the session
    set up and batch 0 folded."""
    with _one_thread(dev):
        return Driver(cfg, mix, seed, dev)


def check(cfg: dict, limits: dict, seed: int, driver: Driver,
          control: bool = False) -> tuple:
    """(numbers, control numbers or None): the embedding stage and the
    values stage (module doc), after the program's result is taken and
    the program freed."""
    with _one_thread(driver.dev):
        return _check(cfg, limits, seed, driver, control)


def _check(cfg, limits, seed, driver, control):
    got = driver.answer()
    sample = int(limits["sample_reviews"])
    if driver.dev.type == "cpu":
        sample = min(sample, CPU_SAMPLE_REVIEWS)
    gaps, ctl_gaps = _embedding_stage(driver, got["emb"], sample, seed,
                                      control)
    if driver.dev.type == "cuda":
        torch.cuda.empty_cache()
    values, ctl_values = _values_stage(cfg, driver, got,
                                       int(limits["value_steps"]), seed,
                                       control)
    numbers = {"embed_median": statistics.median(gaps),
               "embed_max": max(gaps),
               "values_median": statistics.median(values),
               "fold_gap": float(abs(got["t"] - driver.batches * driver.tb))}
    ctl = None
    if control:
        ctl = {"embed_median": statistics.median(ctl_gaps),
               "embed_max": max(ctl_gaps),
               "values_median": statistics.median(ctl_values),
               "fold_gap": 0.0}
    return numbers, ctl
