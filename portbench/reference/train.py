"""The reference's side of a training cell's check: the first steps of
training, from the seed's weights and batches, in plain float32.

``follow`` regenerates the initial weights (``portbench.weights``) and
the batches (``portbench.stream``) from the seed, takes the loss and
its gradient with the configuration's reference family
(``reference/<family>.py``) in blocks of rows, and applies the
configuration's AdamW (``reference/adamw.py``).  It returns what the
check compares: each step's loss, each leaf's norm of the first
gradient as the optimizer gets it (clipped), and each leaf's norm of
the parameters' change after the last step.
"""
from __future__ import annotations

import contextlib
import importlib

import torch

from portbench import stream, weights
from portbench.reference import adamw
from portbench.reference.common import PRECISIONS

TOKENS_PER_BLOCK = 8192     # rows taken together in one forward/backward


def family(config: dict):
    return importlib.import_module(f"portbench.reference.{config['reference']}")


@contextlib.contextmanager
def fp32_products(tf32: bool = False):
    """TF32 off (or on, with ``tf32``) for the products and convolutions
    inside the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def initial_weights(config: dict, seed: int, device) -> dict:
    fam = family(config)
    return weights.make(fam.shapes(config["model"], config["layout"]),
                        config["init"], seed, device)


def loss_and_grads(fam, params: dict, tokens, labels, m: dict, prec):
    """Token-mean loss and its gradient, a block of rows at a time."""
    rows = max(1, TOKENS_PER_BLOCK // tokens.shape[1])
    total = tokens.numel()
    for p in params.values():
        p.grad = None
    loss = 0.0
    for r0 in range(0, tokens.shape[0], rows):
        part = fam.loss_sum(params, tokens[r0:r0 + rows],
                            labels[r0:r0 + rows], m, prec) / total
        part.backward()
        loss += float(part.detach())
    return loss, {k: p.grad for k, p in params.items()}


def follow(config: dict, traffic: dict, seed: int, device, steps: int,
           precision: str = "fp32") -> dict:
    """{"loss": [...], "grad_norm": {leaf: ...}, "update_norm": {leaf:
    ...}} of ``steps`` reference steps in ``precision`` (``"fp32"``, or
    a control of ``reference/common.py``)."""
    prec = PRECISIONS[precision]
    fam = family(config)
    m, opt = config["model"], config["optimizer"]
    b, s = traffic["global_batch"], traffic["seq_len"]
    with fp32_products(prec.tf32):
        params = {k: v.clone().requires_grad_()
                  for k, v in initial_weights(config, seed, device).items()}
        mom = {k: torch.zeros_like(v) for k, v in params.items()}
        vel = {k: torch.zeros_like(v) for k, v in params.items()}
        losses, grad_norm = [], {}
        for i in range(steps):
            toks, labs = stream.batch_at(m["vocab_size"], b, s, seed, i)
            toks = torch.as_tensor(toks, device=device)
            labs = torch.as_tensor(labs, device=device)
            loss, grads = loss_and_grads(fam, params, toks, labs, m, prec)
            losses.append(loss)
            clipped = adamw.step(opt, {k: p.data for k, p in params.items()},
                                 grads, mom, vel, i + 1)
            if i == 0:
                grad_norm = {k: float(torch.linalg.vector_norm(g))
                             for k, g in clipped.items()}
            del grads, clipped
        del mom, vel
        start = initial_weights(config, seed, device)
        update_norm = {k: float(torch.linalg.vector_norm(p.data - start[k]))
                       for k, p in params.items()}
    return {"loss": losses, "grad_norm": grad_norm,
            "update_norm": update_norm}
