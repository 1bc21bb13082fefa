"""The port's sliding-window attention op against the reference.

On the CPU the op runs its plain version (``kernels/swa/ops.py``,
query-chunked and banded); it is held to the reference's Pallas op in
interpret mode and to the reference's pure-jnp oracle, and the port's
own full-softmax oracle (``kernels/swa/ref.py``) to the reference's, at
test_kernels.py's shapes and tolerances (fp32 2e-5, bf16 2e-2 — the
reference's own for this kernel), with GQA, ragged S and softcap.  On
a card (``gpu`` marker) the Hopper kernel is held to the plain version
at the same tolerances, through the path its dtype picks (bf16: the
tensor-core kernel, fp32: the FMA kernel).  A test-local emulation of
the tensor-core kernel's rounding points (bf16 P in P.V, per-tile online
rescale) is held to the reference on the CPU.  Inputs are made with
numpy and fed to both packages."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.swa import swa_attention as j_swa  # noqa: E402
from repro.kernels.swa.ref import swa_attention_ref as j_ref  # noqa: E402
from repro_torch.kernels.swa import kernel as t_kernel  # noqa: E402
from repro_torch.kernels.swa import ops as t_ops  # noqa: E402
from repro_torch.kernels.swa import swa_attention  # noqa: E402
from repro_torch.kernels.swa.ref import swa_attention_ref  # noqa: E402

# test_kernels.py's (s, window) pairs: banded, window == S, ragged S
SHAPES = [(128, 32), (128, 64), (256, 256), (96, 32)]
DTYPES = {"float32": (np.float32, jnp.float32, torch.float32, 2e-5),
          "bfloat16": (None, jnp.bfloat16, torch.bfloat16, 2e-2)}
B, HQ, HKV, D = 2, 4, 2, 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(b, s, hq, hkv, d, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((b, s, hq, d)) * scale).astype(np.float32)
    k = (rng.standard_normal((b, s, hkv, d)) * scale).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    return q, k, v


def _both(arrs, dtype):
    """The same values in both packages, rounded to ``dtype`` once."""
    _, jdt, tdt, _ = DTYPES[dtype]
    t = [torch.from_numpy(a).to(tdt) for a in arrs]
    j = [jnp.asarray(x.to(torch.float32).numpy()).astype(jdt) for x in t]
    return j, t


def _np(x):
    return x.to(torch.float32).numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _bh(x, hq):
    """(B, S, H, D) numpy, KV heads repeated to ``hq`` -> (B*hq, S, D)."""
    b, s, h, d = x.shape
    x = np.repeat(x, hq // h, axis=2)
    return x.transpose(0, 2, 1, 3).reshape(b * hq, s, d)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("s,window", SHAPES)
def test_plain_matches_reference_op_and_oracle(s, window, dtype):
    tol = DTYPES[dtype][3]
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(B, s, HQ, HKV, D, s + window),
                                       dtype)
    got = swa_attention(tq, tk, tv, window=window, block=32)
    assert got.dtype == tq.dtype and tuple(got.shape) == (B, s, HQ, D)
    want = j_swa(jq, jk, jv, window=window, block=32, interpret=True)
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)
    oracle = j_ref(*(jnp.asarray(_bh(_np(x), HQ)).astype(x.dtype)
                     for x in (jq, jk, jv)), window=window)
    oracle = _np(oracle).reshape(B, HQ, s, D).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(_np(got), oracle, rtol=tol, atol=tol)


@pytest.mark.parametrize("block", [16, 32, 256])
def test_plain_does_not_depend_on_its_query_chunk(block):
    """The plain version's query chunks read only their band of keys:
    any chunk size gives the full-softmax oracle's answer."""
    (_, _, _), (tq, tk, tv) = _both(_inputs(1, 96, 2, 1, 16, 5), "float32")
    got = swa_attention(tq, tk, tv, window=24, block=block)
    want = swa_attention_ref(*(torch.from_numpy(_bh(_np(x), 2))
                               for x in (tq, tk, tv)), window=24)
    want = want.reshape(1, 2, 96, 16).permute(0, 2, 1, 3)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-5, atol=2e-5)


def test_softcap_matches_reference():
    """test_kernels.py's softcap case: s 64, window 64, cap 30, scores
    pushed into the cap by inputs scaled by 3."""
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(1, 64, 2, 2, 32, 9, 3.0),
                                       "float32")
    got = swa_attention(tq, tk, tv, window=64, softcap=30.0, block=32)
    want = j_swa(jq, jk, jv, window=64, softcap=30.0, block=32,
                 interpret=True)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-5, atol=2e-5)
    oracle = j_ref(*(jnp.asarray(_bh(_np(x), 2)) for x in (jq, jk, jv)),
                   window=64, softcap=30.0)
    got_ref = swa_attention_ref(*(torch.from_numpy(_bh(_np(x), 2))
                                  for x in (tq, tk, tv)), window=64,
                                softcap=30.0)
    np.testing.assert_allclose(_np(got_ref), _np(oracle), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_ref_matches_reference_oracle(dtype):
    tol = DTYPES[dtype][3]
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(3, 40, 1, 1, 16, 2), dtype)
    flat = [x[:, :, 0] for x in (tq, tk, tv)]
    got = swa_attention_ref(*flat, window=8)
    want = j_ref(*(x[:, :, 0] for x in (jq, jk, jv)), window=8)
    assert got.dtype == tq.dtype
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def test_op_checks_its_operands():
    q = torch.zeros((1, 8, 4, 16))
    k = torch.zeros((1, 8, 3, 16))
    with pytest.raises(ValueError, match="multiple of Hkv"):
        swa_attention(q, k, k, window=4)
    with pytest.raises(ValueError, match="window"):
        swa_attention(q, q, q, window=0)
    with pytest.raises(ValueError, match="CUDA"):
        t_kernel.swa_attention_kernel(q, q, q, window=4, scale=0.25)


def _tc_emulation(q, k, v, *, window, scale, softcap=0.0, bm=64, bn=64):
    """The bf16 tensor-core kernel's arithmetic in fp32 torch on the CPU:
    bf16 q and k, fp32 scores, scale and softcap, the band mask, and an
    online softmax (m, l in fp32, log2 domain) rescaled once per
    ``bn``-key tile that meets a ``bm``-row block's band, with P rounded
    to bf16 before P.V and the sum of P (l) taken before rounding."""
    log2e = 1.4426950408889634
    b, s, hq, d = q.shape
    g = hq // k.shape[2]
    qf = q.to(torch.float32).transpose(1, 2)                 # (b, hq, s, d)
    kf, vf = (x.to(torch.float32).repeat_interleave(g, dim=2)
              .transpose(1, 2) for x in (k, v))
    out = torch.empty_like(qf)
    pos = torch.arange(s)
    for r0 in range(0, s, bm):
        rows = pos[r0:r0 + bm]
        m = torch.full((b, hq, len(rows)), -torch.inf)
        l = torch.zeros_like(m)
        acc = torch.zeros((b, hq, len(rows), d))
        for c0 in range(max(0, r0 - window + 1) // bn * bn,
                        min(r0 + bm, s), bn):
            keys = pos[c0:c0 + bn]
            x = qf[:, :, rows] @ kf[:, :, keys].transpose(-1, -2)
            x = softcap * log2e * torch.tanh(x * (scale / softcap)) \
                if softcap > 0 else x * (scale * log2e)
            band = (keys[None] <= rows[:, None]) & \
                (rows[:, None] - keys[None] < window)
            x = torch.where(band, x, -torch.inf)
            m_new = torch.maximum(m, x.amax(-1))
            base = torch.where(m_new == -torch.inf, 0.0, m_new)
            alpha = torch.exp2(m - base)
            p = torch.exp2(x - base[..., None])
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + \
                p.to(torch.bfloat16).to(torch.float32) @ vf[:, :, keys]
            m = m_new
        out[:, :, rows] = acc / l.clamp_min(1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)


@pytest.mark.parametrize("s,window,softcap", [
    (150, 64, 0.0),     # window < S, ragged S (not a multiple of 64)
    (150, 64, 30.0),    # the same with a softcap
    (150, 256, 0.0),    # window >= S
])
def test_tensor_core_rounding_fits_bf16_tolerance(s, window, softcap):
    """P rounded to bf16 before P.V (the tensor-core kernel's rounding
    points) stays within the bf16 tolerance of the reference's Pallas op
    and oracle at recurrentgemma-9b's heads (16 query, 1 KV, D 256)."""
    b, hq, hkv, d = 1, 16, 1, 256
    scale = 3.0 if softcap else 1.0
    (jq, jk, jv), (tq, tk, tv) = _both(
        _inputs(b, s, hq, hkv, d, 7 + s + window, scale), "bfloat16")
    got = _tc_emulation(tq, tk, tv, window=window, scale=d ** -0.5,
                        softcap=softcap)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (b, s, hq, d)
    want = j_swa(jq, jk, jv, window=window, softcap=softcap, block=64,
                 interpret=True)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-2, atol=2e-2)
    oracle = j_ref(*(jnp.asarray(_bh(_np(x), hq)).astype(x.dtype)
                     for x in (jq, jk, jv)), window=window, softcap=softcap)
    oracle = _np(oracle).reshape(b, hq, s, d).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(_np(got), oracle, rtol=2e-2, atol=2e-2)


def test_bf16_logit_gap_is_amplification_through_the_layers():
    """Why the card's bf16 first-token logits of recurrentgemma-9b through
    the tensor-core kernel differ from the plain version's by 0.125-0.141
    (more than RG_LOGITS_TOL): the model at its published depth (38
    layers, 12 of them local attention), heads (16 query, 1 KV, D 256)
    and window, at a width the CPU holds (d_model 512, d_ff 1536, vocab
    4096; random weights from seed 0), one bf16 prefill of 300 tokens,
    with attention replaced by the kernel's rounding spec (above).  The
    spec moves the logits by the card's order (above 0.05), and so does
    perturbing each attention output by half a bf16 ulp (relative
    Gaussian noise of 2^-9) before it is rounded: the gap is the bf16
    layers amplifying one-ulp differences, not a departure of the kernel
    from its spec."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import init_params, prefill
    from repro_torch.types import param_values

    cfg = dataclasses.replace(get_config("recurrentgemma-9b"), d_model=512,
                              rglru_width=512, d_ff=1536, vocab_size=4096)
    params = param_values(init_params(torch.Generator().manual_seed(0), cfg))
    rng = np.random.default_rng(1)
    batch = {"tokens": torch.as_tensor([rng.integers(3, 4096, 300).tolist()])}
    plain = t_ops.swa_attention
    noise = np.random.default_rng(0)

    def spec(q, k, v, *, window, scale, softcap):
        return _tc_emulation(q, k, v, window=window, scale=scale,
                             softcap=softcap)

    def noisy(q, k, v, **kw):
        y = plain(q, k, v, **kw)
        e = torch.from_numpy(noise.standard_normal(y.shape).astype(np.float32))
        return (y.float() * (1 + 2.0 ** -9 * e)).to(y.dtype)

    def logits(attend):
        t_ops.swa_attention = attend
        try:
            return prefill(params, batch, cfg, 316)[0][:, :4096].float()
        finally:
            t_ops.swa_attention = plain

    base = logits(plain)
    spec_gap = float((logits(spec) - base).abs().max())
    noise_gap = float((logits(noisy) - base).abs().max())
    print(f"recurrentgemma-9b (d_model 512) first-token logits, 300-token "
          f"bf16 prefill: spec vs plain {spec_gap:.4g}, half-ulp noise vs "
          f"plain {noise_gap:.4g}")
    assert spec_gap > 0.05 and noise_gap > 0.05
    assert 0.1 < spec_gap / noise_gap < 10


# the card's cases (b, s, hq, hkv, d, window, softcap, input scale):
# test_kernels.py's (s, window) pairs and a ragged band at every head dim
# the kernels are built for, recurrentgemma-9b's heads (16 query, 1 KV,
# D 256) banded, soft-capped, with window >= S and at its ragged prompt
# (2100 tokens against the 2048 window), and test_kernels.py's softcap case
CARD_CASES = [(B, s, HQ, HKV, D, w, 0.0, 1.0) for s, w in SHAPES] \
    + [(B, 200, HQ, HKV, d, 50, 0.0, 1.0) for d in t_kernel.HEAD_DIMS] \
    + [(1, 300, 16, 1, 256, 64, 0.0, 1.0), (1, 300, 16, 1, 256, 128, 30.0, 3.0),
       (1, 300, 16, 1, 256, 4096, 0.0, 1.0),
       (1, 2100, 16, 1, 256, 2048, 0.0, 1.0),
       (1, 64, 2, 2, 32, 64, 30.0, 3.0)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", CARD_CASES,
                         ids=lambda c: "b{}-s{}-hq{}-hkv{}-d{}-w{}-cap{}".format(
                             *c[:7]))
def test_kernel_matches_plain_on_card(case, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    b, s, hq, hkv, d, window, softcap, scale = case
    tol = DTYPES[dtype][3]
    _, ts = _both(_inputs(b, s, hq, hkv, d, s + window, scale), dtype)
    tq, tk, tv = (x.cuda() for x in ts)
    path = t_kernel.PATHS[tq.dtype][0]
    before, before_path = t_kernel.launches, t_kernel.launches_by_path[path]
    got = swa_attention(tq, tk, tv, window=window, softcap=softcap)
    assert t_kernel.launches == before + 1
    assert t_kernel.launches_by_path[path] == before_path + 1
    want = t_ops.swa_attention_plain(tq, tk, tv, window=window,
                                     softcap=softcap)
    torch.cuda.synchronize()
    np.testing.assert_allclose(_np(got.cpu()), _np(want.cpu()), rtol=tol,
                               atol=tol)


# the dense archs' prefill heads, full causal (window = S): qwen2-0.5b's
# 14 query heads over 2 KV heads of 64 (a group of 7) and granite-3-8b's
# 32 over 8 of 128 — at a ragged length on the CPU, at the full-width
# prompt of 2048 tokens on the card
DENSE_HEADS = [(14, 2, 64), (32, 8, 128)]


@pytest.mark.parametrize("hq,hkv,d", DENSE_HEADS)
def test_tensor_core_rounding_fits_bf16_tolerance_at_dense_heads(hq, hkv, d):
    """The tensor-core kernel's rounding spec (above) over a full causal
    band at the dense archs' heads: an odd GQA group and D 64 / 128,
    S 150 (ragged, three row blocks of 64), against the reference's
    Pallas op and the port's plain version."""
    s = 150
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(1, s, hq, hkv, d, hq + d),
                                       "bfloat16")
    got = _tc_emulation(tq, tk, tv, window=s, scale=d ** -0.5)
    want = j_swa(jq, jk, jv, window=s, block=64, interpret=True)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-2, atol=2e-2)
    plain = swa_attention(tq, tk, tv, window=s)
    np.testing.assert_allclose(_np(got), _np(plain), rtol=2e-2, atol=2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("b,hq,hkv,d", [(1, 14, 2, 64), (2, 32, 8, 128)],
                         ids=["qwen2-0.5b", "granite-3-8b"])
def test_tc_kernel_full_causal_at_dense_heads_on_card(b, hq, hkv, d):
    """``swa_tc_kernel`` over the full causal band of a 2048-token prompt
    (window = S) at the dense archs' heads, against the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    s = 2048
    _, ts = _both(_inputs(b, s, hq, hkv, d, hq + d), "bfloat16")
    tq, tk, tv = (x.cuda() for x in ts)
    before = t_kernel.launches_by_path["tc"]
    got = swa_attention(tq, tk, tv, window=s)
    assert t_kernel.launches_by_path["tc"] == before + 1
    want = t_ops.swa_attention_plain(tq, tk, tv, window=s)
    torch.cuda.synchronize()
    np.testing.assert_allclose(_np(got.cpu()), _np(want.cpu()), rtol=2e-2,
                               atol=2e-2)
