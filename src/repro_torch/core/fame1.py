"""FAME-1 token-based target-clock decoupling, as PyTorch combinators.

FireSim turns target RTL into a token simulator: every component consumes
one input token and produces one output token per *target* cycle, and is
stalled (clock-gated) on host cycles where a token is unavailable — the
paper's contribution is the Chisel pass that applies this to NVDLA's
Verilog via clock gating (Fig. 3b).

The PyTorch analogue: a target-cycle step function ``f(state, x) ->
(state, y)`` on tensors is wrapped so a *host* schedule of token-valid
bits drives it.  On a host cycle with no token the state passes through
unchanged — clock gating is ``torch.where`` (Fig. 3b's mux, literally).
The defining FAME-1 property — target-visible behaviour is bit-identical
for every stall pattern — holds by construction and is property-tested
with randomized schedules against the reference package
(tests/test_torch_fame1.py).

``FAME1Pipeline`` chains components through single-entry token queues,
the shape of the paper's Figure 2 (NVDLA -> front bus -> LLC/DRAM model),
where a downstream stall back-pressures upstream components exactly as
FireSim's channels do.  Which component fires on which host cycle — the
channels' full/empty bits, the source and sink cursors and the early
exit — depends only on the stall schedule, never on token values, so
``run`` plans it on the host in one pass over the schedule and the
device runs each component's step on exactly the tokens it fired on: no
device sync per host cycle, and the same states, outputs and
``last_host_cycles`` as the reference's chunked early-exit scheduler
(all-stall cycles compacted away, the schedule replayed in
``chunk_cycles``-cycle chunks until the sink has drained every token).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.types import tree_map


def _leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def _select_tree(pred, new, old):
    return tree_map(lambda a, b: torch.where(pred, a, b), new, old)


def chunked_scan(step_fn, init_carry, xs, *, cont_fn,
                 chunk_len: int = 64, pow2_bucket: bool = True):
    """Token-bundle execution of a per-target-cycle scan: replay ``xs``
    in ``chunk_len``-cycle bundles, stopping as soon as
    ``cont_fn(carry)`` goes False — the ``FAME1Pipeline.run`` early-exit
    pattern, factored out so other token simulators batch k target
    cycles per host step through one combinator.

    ``step_fn(carry, x, active) -> (carry, y)`` is one target cycle
    (``active`` a 0-dim bool tensor); it MUST be a no-op on
    ``active=False`` cycles (bundle padding), which is exactly the
    FAME-1 clock-gate contract — and what makes the result provably
    invariant to ``chunk_len``, including bundle sizes that do not
    divide the cycle count.

    ``xs`` leaves are (H, ...) tensors; the schedule is zero-padded to a
    whole number of bundles (``pow2_bucket`` rounds the bundle count to
    a power of two, as the reference does to share compiled programs).
    Returns ``(carry, ys, bundles_run)`` where ``ys`` leaves are
    (n_bundles * chunk_len, ...) — entries past the executed bundles
    hold zeros, so per-cycle outputs must carry their own validity bit.
    ``cont_fn`` is read once per bundle (one device sync per bundle);
    the padded schedule and the per-cycle ``active`` bits are made on
    the device once, so a cycle only takes views of them."""
    if chunk_len < 1:
        raise ValueError(f"chunk_len must be >= 1, got {chunk_len}")
    xs = tree_map(torch.as_tensor, xs)
    first = _leaves(xs)[0]
    h_total, dev = first.shape[0], first.device
    n_chunks = max(1, -(-h_total // chunk_len))
    if pow2_bucket:
        n_chunks = 1 << (n_chunks - 1).bit_length()
    n_cycles = n_chunks * chunk_len
    xs = tree_map(lambda a: torch.cat([a, a.new_zeros(
        (n_cycles - h_total,) + tuple(a.shape[1:]))]), xs)
    active = torch.arange(n_cycles, device=dev) < h_total

    def x_at(t):
        return tree_map(lambda a: a[t], xs)

    # output layout from an inactive (no-op) cycle, as eval_shape gives
    _, y0 = step_fn(init_carry, x_at(0), torch.zeros((), dtype=torch.bool,
                                                      device=dev))
    ys = tree_map(lambda y: torch.zeros((n_cycles,) + tuple(y.shape),
                                        dtype=y.dtype, device=y.device), y0)
    ys_leaves = _leaves(ys)
    carry, ci = init_carry, 0
    while ci < n_chunks and bool(cont_fn(carry)):
        t0 = ci * chunk_len
        outs = []
        for t in range(t0, t0 + chunk_len):
            carry, y = step_fn(carry, x_at(t), active[t])
            outs.append(_leaves(y))
        for buf, col in zip(ys_leaves, zip(*outs)):
            buf[t0:t0 + chunk_len] = torch.stack(col).to(buf.dtype)
        ci += 1
    return carry, ys, ci


def fame1_wrap(step_fn: Callable):
    """f(state, x) -> (state, y)  ==>  h((state,), (x, valid)) which holds
    state and emits an invalid token when `valid` is False."""

    def host_step(state, inp):
        x, valid = inp
        new_state, y = step_fn(state, x)
        state = _select_tree(valid, new_state, state)
        return state, (y, valid)

    return host_step


def run_hosted(step_fn, init_state, tokens, valid_mask):
    """Run `step_fn` under a host schedule.

    tokens: (H, ...) per-host-cycle input (entries where valid_mask is
    False are ignored); valid_mask: (H,) bool.  Returns (final_state,
    outputs (H, ...), n_valid) where the first n_valid outputs are the
    *target*-cycle view, independent of the stall pattern.
    """
    hosted = fame1_wrap(step_fn)
    valid_mask = torch.as_tensor(valid_mask, dtype=torch.bool)
    state, ys = init_state, []
    for h in range(valid_mask.shape[0]):
        state, (y, _) = hosted(
            state, (tree_map(lambda a: a[h], tokens), valid_mask[h]))
        ys.append(y)
    stacked = tree_map(lambda *y: torch.stack(y), *ys)
    # compact to target cycles: stable order of the valid outputs
    order = torch.sort((~valid_mask).to(torch.int8), stable=True).indices
    n_valid = valid_mask.sum()
    return state, tree_map(lambda y: y[order], stacked), n_valid


@dataclasses.dataclass
class Component:
    """A FAME-1-transformed target component."""
    name: str
    step_fn: Callable                    # (state, x) -> (state, y)
    init_state: Any
    init_output: Any                     # token value emitted before any input


def _plan_fires(stalls: np.ndarray, n_active: int, t_total: int, n: int,
                chunk: int | None) -> tuple[list[int], int, int]:
    """The reference host program's control path, on the host: per host
    cycle the source pushes into an empty channel 0, component i fires
    iff channel i is full, channel i+1 empty and i is not stalled (each
    fire moves the token on within the cycle), and the sink drains
    channel n.  Returns (fires per component, tokens drained, host
    cycles spent) — ``chunk`` replays in chunks of that many cycles and
    stops after the chunk in which the sink drained the last token,
    counting only the active (unpadded) cycles of the chunks run."""
    full = [False] * (n + 1)
    fires = [0] * n
    src = out = 0
    h = 0
    rows = stalls.tolist()
    while h < n_active and out < t_total:
        if not full[0] and src < t_total:
            full[0] = True
            src += 1
        row = rows[h]
        for i in range(n):
            if full[i] and not full[i + 1] and not row[i]:
                full[i], full[i + 1] = False, True
                fires[i] += 1
        if full[n]:
            full[n] = False
            out += 1
        h += 1
    if chunk is None:
        return fires, out, n_active
    # the reference counts whole chunks up to the one that drained
    return fires, out, min(n_active, -(-h // chunk) * chunk)


class FAME1Pipeline:
    """Chain of components with single-slot token channels between them.

    Each host cycle: component i fires iff its input channel holds a token
    and its output channel is empty (downstream consumed).  An external
    stall pattern may additionally gate any component — simulating host
    non-determinism (DRAM delays, FPGA stalls).  Target behaviour is
    invariant to that pattern (the FAME-1 guarantee).
    """

    def __init__(self, components: list[Component]):
        self.components = components
        self.last_host_cycles: int | None = None   # set by run(), for perf
                                                   # accounting/benchmarks

    def _replay(self, inputs, fires: list[int], drained: int):
        """Each component's step over the tokens it fired on, in order:
        the k-th fire of component i consumes the k-th output of
        component i-1 (single-slot FIFO channels), so this is the host
        schedule's target-visible result without its idle cycles."""
        t_total = _leaves(inputs)[0].shape[0]
        vals = [tree_map(lambda a: a[k], inputs)
                for k in range(min(fires[0], t_total))] if fires else []
        states = []
        for comp, n_fire in zip(self.components, fires):
            state, outs = comp.init_state, []
            for k in range(n_fire):
                state, y = comp.step_fn(state, vals[k])
                outs.append(y)
            states.append(state)
            vals = outs
        out_buf = tree_map(
            lambda y: torch.zeros((t_total,) + tuple(torch.as_tensor(y).shape),
                                  dtype=torch.as_tensor(y).dtype,
                                  device=torch.as_tensor(y).device),
            self.components[-1].init_output)
        if drained:
            for buf, *col in zip(_leaves(out_buf),
                                 *(_leaves(v) for v in vals[:drained])):
                buf[:drained] = torch.stack(col).to(buf.dtype)
        return tuple(states), out_buf

    def run(self, inputs, host_stalls=None, max_host_cycles: int | None = None,
            *, early_exit: bool = True, chunk_cycles: int = 64):
        """inputs: (T, ...) source tokens.  host_stalls: (H, n_components)
        bool — True = stall that component that cycle.

        With ``early_exit`` (default) the schedule is first compacted —
        all-stall host cycles are dropped, since source push and sink
        drain are retried identically on the next cycle — and then
        replayed in ``chunk_cycles``-cycle chunks that stop as soon as
        all T tokens have drained.  ``early_exit=False`` replays the
        fixed schedule exactly as given; both paths produce
        bit-identical target-visible results.  Returns (component
        states, (T, ...) sink outputs, tokens drained).
        """
        n = len(self.components)
        inputs = tree_map(torch.as_tensor, inputs)
        t_total = _leaves(inputs)[0].shape[0]
        fires, drained, cycles = plan_schedule(
            t_total, n, host_stalls, max_host_cycles,
            early_exit=early_exit, chunk_cycles=chunk_cycles)
        states, outs = self._replay(inputs, fires, drained)
        self.last_host_cycles = cycles
        return states, outs, drained


def plan_schedule(t_total: int, n: int, host_stalls=None,
                  max_host_cycles: int | None = None, *,
                  early_exit: bool = True, chunk_cycles: int = 64
                  ) -> tuple[list[int], int, int]:
    """``FAME1Pipeline.run``'s host schedule for ``t_total`` tokens
    through ``n`` components: (fires per component, tokens drained, the
    reference scheduler's host cycles).  It depends only on the stall
    schedule, never on token values, so a caller that computes the
    components' steps another way (``socsim``'s card route) plans with it
    too."""
    if host_stalls is None:
        h_total = max_host_cycles or (4 * t_total * (n + 1))
        stalls = np.zeros((h_total, n), bool)
    else:
        stalls = (host_stalls.detach().cpu().numpy()
                  if isinstance(host_stalls, torch.Tensor)
                  else np.asarray(host_stalls)).astype(bool)
        if early_exit:
            # pre-compaction: an all-stall cycle cannot change target
            # -visible behaviour (FAME-1 invariance), so skip it
            stalls = stalls[~stalls.all(axis=1)]
    return _plan_fires(stalls, stalls.shape[0], t_total, n,
                       chunk_cycles if early_exit else None)
