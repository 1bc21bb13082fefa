"""The SSD backward kernel (``csrc/ssd_bwd.cu``) on the card, grid by
grid: builds it, prints its ``ptxas`` report, and at each shape launches
it once and holds the C.B^T scratch (``ssd_bwd_cb``), gCB summed over
its head-group partials (``ssd_bwd_ds``) and the five gradients against
the plain backward in float64 (relative to each one's max|x|).  At
mamba2-130m's training shape it checks that two launches are bit-equal,
then times the whole backward (CUDA events around calls queued behind a
device-side wait, as ``chip_smoke.queued_ms``) and each grid (the
profiler).  Everything it reads goes to ``chiprun_out/ssd_bwd_probe.json``.

    python3 scripts/ssd_bwd_probe.py [--quick]

``--quick`` stops after the correctness checks.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.ssd import kernel as K  # noqa: E402
from repro_torch.kernels.ssd import ops, ref  # noqa: E402

TRAIN = (4, 2048, 256, 24, 64, 128)
# (bb, l, chunk, h, p, n): the forward's test shapes, a ragged chunk of
# 40 at 3 heads, p and n off the 16-byte strides TMA needs (the 4-byte
# copy route), one ragged chunk of 300 at 3 heads, 12 heads (a head group
# that h does not fill), and the training shape
SHAPES = [(2, 64, 32, 4, 16, 32), (1, 40, 32, 3, 16, 24), (2, 128, 32, 8, 32, 64),
          (1, 96, 32, 3, 10, 20), (1, 300, 256, 3, 64, 128), (2, 512, 256, 12, 64, 128),
          TRAIN]


def operands(shape, gen, dev):
    bb, l, chunk, h, p, n = shape
    x = torch.randn((bb, l, h, p), generator=gen, device=dev)
    dt = torch.nn.functional.softplus(torch.randn((bb, l, h), generator=gen, device=dev))
    A = -torch.exp(0.5 * torch.randn((h,), generator=gen, device=dev))
    B = torch.randn((bb, l, n), generator=gen, device=dev)
    C = torch.randn((bb, l, n), generator=gen, device=dev)
    chunked = ops._chunked(x, dt, A, B, C, chunk)
    nc, q = chunked[0].shape[1], chunked[0].shape[2]
    gy = torch.randn((bb, nc, q, h, p), generator=gen, device=dev)
    gst = torch.randn((bb, nc, h, n, p), generator=gen, device=dev)
    return tuple(t.contiguous() for t in (*chunked, gy, gst))


def rel(got, want) -> float:
    return float((got.double() - want).abs().max() / want.abs().max().clamp_min(1e-300))


def launch(ops_):
    """The wrapper's launch, keeping the scratch."""
    x = ops_[0]
    bb, nc, q, h, p = x.shape
    n = ops_[3].shape[-1]
    plan = K.bwd_plan(bb * nc, q, h, p, n)
    grads = tuple(torch.empty_like(t) for t in ops_[:5])
    scratch = {k: torch.empty(s, dtype=torch.float32, device=x.device)
               for k, s in plan["scratch"].items()}
    lib = K._bwd_library()
    err = lib.ssd_bwd_launch(*(t.data_ptr() for t in (*ops_, *grads, *scratch.values())),
                             bb * nc, q, h, p, n, torch.cuda.current_stream().cuda_stream)
    _build.check(lib, "ssd_bwd", err)
    return grads, scratch, plan


def check(shape, gen, dev) -> dict:
    ops_ = operands(shape, gen, dev)
    x, dt, cum, B, C, gy, gst = ops_
    bb, nc, q, h, p = x.shape
    grads, scratch, plan = launch(ops_)
    torch.cuda.synchronize()
    L, qp = plan["tiles"], plan["qp"]
    cells = bb * nc
    Bd, Cd = (t.double().reshape(cells, q, -1) for t in (B, C))
    cb = torch.einsum("cln,csn->cls", Cd, Bd)
    causal_tiles = torch.zeros(qp, qp, dtype=torch.bool, device=dev)
    for lt in range(L):
        causal_tiles[64 * lt:64 * lt + 64, :64 * lt + 64] = True
    mask = causal_tiles[:q, :q]
    got_cb = scratch["cb"][:, :q, :q].double()
    zero = torch.zeros((), dtype=torch.float64, device=dev)
    out = {"shape": shape,
           "cb": float(torch.where(mask, (got_cb - cb).abs(), zero).max()
                       / cb.abs().max())}
    # gCB from the plain backward's pieces, in float64
    xd, gyd, cumd, dtd = (t.double().reshape(cells, q, h, -1) for t in (x, gy, cum, dt))
    cumd, dtd = cumd[..., 0], dtd[..., 0]
    tri = torch.tril(torch.ones(q, q, dtype=torch.bool, device=dev))
    seg = cumd[:, :, None, :] - cumd[:, None, :, :]
    dec = torch.exp(torch.where(tri[None, :, :, None], seg, torch.tensor(-1e30, device=dev,
                                                                        dtype=seg.dtype)))
    ds = torch.einsum("clhp,cshp->clsh", gyd, xd) * tri[None, :, :, None]
    gcb = (ds * dec * dtd[:, None, :, :]).sum(-1)
    got_gcb = scratch["gcbp"].sum(1)[:, :q, :q].double()
    out["gcb"] = float(torch.where(mask, (got_gcb - gcb).abs(), zero).max()
                       / gcb.abs().max())
    want = ref.ssd_intra_chunk_bwd_ref(*(t.double() for t in ops_))
    out["grads"] = {name: rel(a, w) for name, a, w in
                    zip(("gx", "gdt", "gcum", "gB", "gC"), grads, want)}
    out["finite"] = all(bool(torch.isfinite(a).all()) for a in grads)
    print(json.dumps(out), flush=True)
    return out


def split_of(fn) -> dict:
    import chip_smoke

    return {part: chip_smoke.device_ms(fn, 5, f"ssd_bwd_{part}", expect=5)
            for part in ("cb", "ds", "dx", "bc", "reduce")}


def queued_ms(fn, reps: int) -> float:
    import chip_smoke

    return chip_smoke.queued_ms(fn, reps)


def main() -> int:
    quick = "--quick" in sys.argv
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(name, smi.strip(), flush=True)
    lib = K._bwd_library()
    print(_build.report("ssd_bwd"), flush=True)
    print("smem", K.bwd_smem_bytes(), "head groups", K.built_head_groups(),
          "blocks an SM", K.bwd_blocks_per_sm(), flush=True)
    gen = torch.Generator(device=dev).manual_seed(7)
    record = {"device": name, "smi": smi.strip(), "checks": []}
    ok = True
    for shape in SHAPES:
        res = check(shape, gen, dev)
        record["checks"].append(res)
        ok &= res["finite"] and max(res["grads"].values()) <= 1e-4
    ops_ = operands(TRAIN, gen, dev)
    runs = [K.ssd_intra_chunk_bwd_kernel(*ops_) for _ in range(2)]
    record["bit_equal"] = all(torch.equal(a, b) for a, b in zip(*runs))
    print("bit-equal", record["bit_equal"], flush=True)
    ok &= record["bit_equal"]
    if not quick:
        def kernel():
            return K.ssd_intra_chunk_bwd_kernel(*ops_)

        record["ms"] = [queued_ms(kernel, 20) for _ in range(3)]
        record["split_ms"] = split_of(kernel)
        bb, l, chunk, h, p, n = TRAIN
        cells = bb * (l // chunk)
        record["issued_gflop"] = cells * K.bwd_issued_flops(chunk, h, p, n) / 1e9
        print(json.dumps({k: record[k] for k in ("ms", "split_ms", "issued_gflop")}),
              flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "ssd_bwd_probe.json").write_text(json.dumps(record, indent=1))
    print("ok" if ok else "FAILED", flush=True)
    del lib
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
