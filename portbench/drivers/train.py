"""Training cells: the port's own step, driven as its loop drives it.

Set-up builds the training state once: the configuration's weights,
made on the device from the seed (``portbench.weights``), handed to the
port's ``init_train_state``, and ``make_train_step``'s step.  It drives
that state through the traffic's ``setup_steps`` first steps, each as
the port's loop runs one (``train/loop._run_segment``)::

    batch = stream.batch_at(step)              # the port's SyntheticStream
    state, metrics = train_step(state, batch)
    float(metrics["loss"])                     # the step barrier

and reads what the check compares: each loss, the first gradient as the
optimizer got it (AdamW's first moment after step one over 1 - b1) and
the parameters' change after the last set-up step.  Those steps warm up
every shape.  The timed window then carries the same state on, step
after step, until ``seconds`` have passed; with ``--trace 1`` a few
more steps run under the profiler.  Then the program's state is freed
and the reference follows the set-up steps (``reference/train.py``).

The benchmark's own spans split each step: ``data`` (``batch_at``),
``dispatch`` (the step call to its return, before the barrier) and
``barrier`` (``float(loss)``).
"""
from __future__ import annotations

import gc
import importlib
import math
import time

import torch

from portbench import correctness, trace
from portbench.reference import train as ref_train


def _leaves(tree, prefix=""):
    """(path, leaf) of a tree of dicts and tuples, dict keys sorted."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}{k}.")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}{i}.")
    elif tree is not None:
        yield prefix[:-1], tree


def _rebuild(tree, values: dict, prefix=""):
    if isinstance(tree, dict):
        return {k: _rebuild(v, values, f"{prefix}{k}.")
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(v, values, f"{prefix}{i}.")
                          for i, v in enumerate(tree))
    return values[prefix[:-1]]


def _norms(tree, scale: float = 1.0) -> dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.detach().float())) * scale
            for k, v in _leaves(tree)}


class Program:
    """The port's training step and state for one configuration, mix,
    seed and device."""

    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 fault: str | None = None):
        from repro_torch.configs.base import ModelConfig
        from repro_torch.data.synthetic import SyntheticStream
        from repro_torch.models import init_params
        from repro_torch.train import step as step_mod
        from repro_torch.train.optim import AdamWConfig
        from repro_torch.types import param_values

        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.cfg = ModelConfig(**{k: tuple(v) if isinstance(v, list) else v
                                  for k, v in config["model"].items()})
        self.opt = AdamWConfig(**config["optimizer"])
        b, s = traffic["global_batch"], traffic["seq_len"]
        self.tokens_per_step = b * s
        self.stream = SyntheticStream(self.cfg, b, s, seed=seed,
                                      device=self.device)
        self.train_step = step_mod.make_train_step(self.cfg, self.opt)
        layout = param_values(init_params(0, self.cfg, device="meta"))
        start = ref_train.initial_weights(config, seed, self.device)
        mine = {k: tuple(v.shape) for k, v in _leaves(layout)}
        theirs = {k: tuple(v.shape) for k, v in start.items()}
        if mine != theirs:
            raise ValueError(f"the port's parameters {mine} are not the "
                             f"configuration's {theirs}")
        self.state = step_mod.init_train_state(_rebuild(layout, start))
        del start
        self.batch_at, self.step_fn = self.stream.batch_at, self.train_step
        if fault is not None:
            FAULTS[fault](self)

    def one_step(self, step: int) -> tuple[float, tuple]:
        """One step as the loop runs it: (loss, (data, dispatch, barrier)
        seconds)."""
        from torch.profiler import record_function

        t0 = time.perf_counter()
        with record_function(trace.SPAN_PREFIX + "data"):
            batch = self.batch_at(step)
        t1 = time.perf_counter()
        with record_function(trace.SPAN_PREFIX + "dispatch"):
            self.state, metrics = self.step_fn(self.state, batch)
        t2 = time.perf_counter()
        with record_function(trace.SPAN_PREFIX + "barrier"):
            loss = float(metrics["loss"])
        t3 = time.perf_counter()
        return loss, (t1 - t0, t2 - t1, t3 - t2)

    def setup_steps(self, n: int) -> dict:
        """The first ``n`` steps, and the check's record of them."""
        losses, grad = [], {}
        for i in range(n):
            loss, _ = self.one_step(i)
            losses.append(loss)
            if i == 0:
                grad = _norms(self.state.opt["m"], 1.0 / (1.0 - self.opt.b1))
        start = ref_train.initial_weights(self.config, self.seed,
                                          self.device)
        update = {k: float(torch.linalg.vector_norm(
            v.detach().float() - start[k]))
            for k, v in _leaves(self.state.params)}
        del start
        return {"loss": losses, "grad_norm": grad, "update_norm": update}


# Faults planted under the timed path, for the tests and the readings
# that set the limits (``portbench/readings.py``); never in a run of
# ``run.py``.
def _state_unchanged(prog: Program) -> None:
    step = prog.step_fn

    def unchanged(state, batch):
        _, metrics = step(state, batch)
        return state, metrics
    prog.step_fn = unchanged


def _half_batch(prog: Program) -> None:
    feed = prog.batch_at

    def half(i):
        batch = feed(i)
        return {k: v[:v.shape[0] // 2] for k, v in batch.items()}
    prog.batch_at = half


def _answer_altered(prog: Program) -> None:
    """The step's answer altered where it is produced: the embedding's
    new value moved twice as far as the step moved it."""
    step = prog.step_fn

    def altered(state, batch):
        old = state.params["embed"]["embed"].detach()
        state, metrics = step(state, batch)
        new = state.params["embed"]["embed"]
        with torch.no_grad():
            new.add_(new - old)
        return state, metrics
    prog.step_fn = altered


FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch,
          "answer_altered": _answer_altered}


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _counters(names) -> dict:
    out = {}
    for module, attr in names:
        out[(module, attr)] = getattr(importlib.import_module(module), attr)
    return out


def run(cell, *, seed: int, seconds: float, traced: bool, device,
        t_start: float, counters=(), fault: str | None = None) -> dict:
    """One run of a training cell: the record its metrics' readers and
    the result line read."""
    traffic = cell.traffic
    device = torch.device(device)
    t_built = time.perf_counter()
    prog = Program(cell.config, traffic, seed, device, fault=fault)
    _sync(device)
    t_steps = time.perf_counter()
    found = prog.setup_steps(traffic["setup_steps"])
    _sync(device)
    setup_s = time.perf_counter() - t_start
    phases = {"start_s": t_built - t_start, "state_s": t_steps - t_built,
              "setup_steps_s": t_start + setup_s - t_steps}

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    steps, failed = [], 0
    step = traffic["setup_steps"]
    _sync(device)
    t0 = time.perf_counter()
    while True:
        loss, spans = prog.one_step(step)
        steps.append(spans)
        failed += not math.isfinite(loss)
        step += 1
        if time.perf_counter() - t0 >= seconds:
            break
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0

    tr, launches = None, {}
    if traced:
        before = _counters(counters)
        n = traffic["profiled_steps"]

        def profiled_steps():
            nonlocal step
            for _ in range(n):
                prog.one_step(step)
                step += 1
        tr = trace.profiled(profiled_steps, device)
        after = _counters(counters)
        launches = {k: after[k] - before[k] for k in counters}

    tokens_per_step = prog.tokens_per_step
    prog.state = None
    del prog
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    ref = ref_train.follow(cell.config, traffic, seed, device,
                           traffic["setup_steps"])
    return {"config": cell.config, "traffic": traffic,
            "setup_s": setup_s, "window_s": window_s, "steps": steps,
            "failed": failed, "tokens_per_step": tokens_per_step,
            "peak_bytes": peak, "trace": tr,
            "profiled_steps": traffic["profiled_steps"] if traced else 0,
            "launches": launches, "program": found, "reference": ref,
            "setup_phases": phases,
            "numbers": correctness.numbers(found, ref)}
