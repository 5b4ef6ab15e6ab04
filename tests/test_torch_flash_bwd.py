"""PyTorch port: the flash-attention backward on the CPU against autograd and
against ``jax.grad`` of the reference.

On the CPU ``ops.flash_attention``'s gradient is the backward kernel's plain
version (``kernels.ref.flash_attention_bwd_plain``: from the forward's row
statistics, block by block). It is held against autograd through the
forward's plain version, against ``jax.grad`` of the reference's
``_chunked_attention`` (the reference's long-S lowering, which it trains
through) and, where every row has a key, of its ``mha_reference``, on the
same numpy-seeded inputs and output gradient. Tolerances: 2e-5 (abs and
rel) in f32, where the frameworks order their sums differently (the
forward's limit); bf16 inputs get 2**-7 rel plus 2e-2 abs, one bf16 ulp of
the gradient's rounding on either side plus the sum order near 0.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as rref
from repro.models.layers import _chunked_attention
from repro_torch.kernels import flash_attention as kernel
from repro_torch.kernels import ops, ref

CASES = [  # (B, Hq, Hkv, Sq, Sk, D, causal)
    (1, 2, 1, 64, 64, 32, True),      # g = 2
    (2, 2, 2, 64, 96, 64, True),      # g = 1, Sq < Sk
    (1, 7, 1, 96, 32, 32, True),      # g = 7, Sq > Sk: rows with no key
    (1, 4, 2, 64, 64, 128, True),     # D = 128
    (1, 4, 2, 64, 64, 32, False),     # not causal
    (1, 7, 1, 96, 32, 64, False),     # not causal, Sq > Sk
]
TOL = {"float32": (2e-5, 2e-5), "bfloat16": (2e-2, 2.0 ** -7)}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float64": torch.float64}
BLOCK = 32


def _inputs(seed, B, Hq, Hkv, Sq, Sk, D):
    """q, k, v (v the model's transposed view) and dO, from numpy."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Hq, Sq, D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, Sk, D)).astype(np.float32)
    v = rng.standard_normal((B, Sk, Hkv, D)).astype(np.float32).transpose(0, 2, 1, 3)
    do = rng.standard_normal((B, Hq, Sq, D)).astype(np.float32)
    return q, k, v, do


def _t(a, dtype="float32", grad=False):
    t = torch.from_numpy(np.ascontiguousarray(a)).to(_TORCH[dtype])
    return t.requires_grad_(grad)


def _close(a, b, dtype="float32"):
    atol, rtol = TOL[dtype]
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32),
                               atol=atol, rtol=rtol)


def _ours(arrs, dtype="float32", causal=True):
    """Gradients through ``ops.flash_attention`` (the plain backward)."""
    q, k, v = (_t(a, dtype, grad=True) for a in arrs[:3])
    v_view = _t(arrs[2].transpose(0, 2, 1, 3), dtype).transpose(1, 2).requires_grad_(True)
    assert v_view.shape[1] == 1 or not v_view.is_contiguous()  # one kv head: contiguous
    out = ops.flash_attention(q, k, v_view, causal=causal, block_q=BLOCK, block_k=BLOCK)
    grads = torch.autograd.grad(out, (q, k, v_view), _t(arrs[3], dtype))
    assert [g.dtype for g in grads] == [_TORCH[dtype]] * 3
    return [g.float().numpy() for g in grads]


def _jax_grads(fn, arrs, dtype="float32"):
    js = [jnp.asarray(a, dtype) for a in arrs]
    grads = jax.grad(lambda q, k, v: jnp.sum(fn(q, k, v).astype(jnp.float32)
                                             * js[3].astype(jnp.float32)),
                     argnums=(0, 1, 2))(*js[:3])
    return [np.asarray(g, np.float32) for g in grads]


def _chunked(causal, D):
    return lambda q, k, v: _chunked_attention(q, k, v, causal=causal, prefix_len=None,
                                              scale=1.0 / np.sqrt(D), block_q=BLOCK,
                                              block_k=BLOCK)


@pytest.mark.parametrize("case", CASES, ids=str)
def test_plain_backward_matches_autograd_through_plain_forward(case):
    *shape, causal = case
    arrs = _inputs(0, *shape)
    q, k, v = (_t(a, grad=True) for a in arrs[:3])
    out, m, l = ref.flash_attention_plain(q, k, v, causal=causal, block_q=BLOCK,
                                          block_k=BLOCK, return_stats=True)
    want = torch.autograd.grad(out, (q, k, v), _t(arrs[3]))
    got = ref.flash_attention_bwd_plain(*(t.detach() for t in (q, k, v, out, m, l)),
                                        _t(arrs[3]), causal=causal, block_q=BLOCK,
                                        block_k=BLOCK)
    for a, b in zip(got, want):
        _close(a.numpy(), b.numpy())


@pytest.mark.parametrize("case", CASES, ids=str)
def test_matches_jax_grad_of_chunked_attention(case):
    *shape, causal = case
    arrs = _inputs(1, *shape)
    for a, b in zip(_ours(arrs, causal=causal),
                    _jax_grads(_chunked(causal, shape[-1]), arrs)):
        _close(a, b)


@pytest.mark.parametrize("case", [c for c in CASES if c[3] <= c[4]], ids=str)
def test_matches_jax_grad_of_mha_reference(case):
    """Every row has a key here: the dense oracle masks with -inf, which is
    NaN for a row with none."""
    *shape, causal = case
    arrs = _inputs(2, *shape)
    want = _jax_grads(lambda q, k, v: rref.mha_reference(q, k, v, causal=causal), arrs)
    for a, b in zip(_ours(arrs, causal=causal), want):
        _close(a, b)


@pytest.mark.parametrize("shape", [(1, 7, 1, 96, 32, 64), (1, 14, 2, 64, 64, 64)], ids=str)
def test_bf16_matches_jax_grad_of_chunked_attention(shape):
    """bf16 inputs: f32 inside, each gradient rounded to bf16 once."""
    arrs = _inputs(3, *shape)
    got = _ours(arrs, "bfloat16")
    for a, b in zip(got, _jax_grads(_chunked(True, shape[-1]), arrs, "bfloat16")):
        _close(a, b, "bfloat16")


def test_rows_with_no_key_spread_do_over_every_key_and_get_no_dq():
    """Sq > Sk, causal: rows 0..Sq-Sk-1 weigh each key by 1/Sk in dv (their
    output is the mean of v), and dS is 0 at every masked position, so
    their dq is exactly 0."""
    B, Hq, Hkv, Sq, Sk, D = 1, 2, 1, 96, 32, 32
    arrs = _inputs(4, B, Hq, Hkv, Sq, Sk, D)
    q, k, v = (_t(a) for a in arrs[:3])
    do = torch.zeros((B, Hq, Sq, D))
    do[:, :, : Sq - Sk] = _t(arrs[3])[:, :, : Sq - Sk]
    out, m, l = ref.flash_attention_plain(q, k, v, block_q=BLOCK, block_k=BLOCK,
                                          return_stats=True)
    assert bool((m[:, :, : Sq - Sk] == -1e30).all())
    assert bool((l[:, :, : Sq - Sk] == Sk).all())
    dq, dk, dv = ref.flash_attention_bwd_plain(q, k, v, out, m, l, do, block_q=BLOCK,
                                               block_k=BLOCK)
    assert bool((dq == 0).all()) and bool((dk == 0).all())
    want = do.sum(dim=(1, 2))[:, None, None] / Sk
    _close(dv.numpy(), want.expand(B, Hkv, Sk, D).numpy())


@pytest.fixture
def one_thread():
    """gradcheck runs thousands of tiny f64 ops: intra-op threads only
    contend with the other test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# causal: a group of 2; Sq > Sk, so rows 0..5 have no key; 3 q blocks and 3
# key blocks, one q block mixing rows with and without a key, and the
# diagonal cutting through key blocks (an offset of -6 at blocks of 4 and
# 2). No block is ragged: the entry point, like the reference's, refuses a
# sequence that its block does not divide (the card kernel's ragged tiles
# are tested on the card)
@pytest.mark.parametrize("causal,shape,blocks", [(True, (1, 4, 2, 12, 6, 16), (4, 2)),
                                                 (False, (1, 2, 1, 16, 24, 32), (8, 8))],
                         ids=str)
def test_gradcheck_of_the_autograd_function_in_f64(one_thread, causal, shape, blocks):
    B, Hq, Hkv, Sq, Sk, D = shape
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal(s)).requires_grad_(True)
               for s in ((B, Hq, Sq, D), (B, Hkv, Sk, D), (B, Hkv, Sk, D)))

    def fn(q, k, v):
        return ops.flash_attention(q, k, v, causal=causal, block_q=blocks[0],
                                   block_k=blocks[1])

    assert torch.autograd.gradcheck(fn, (q, k, v))


def test_statistics_only_when_a_gradient_is_taken(monkeypatch):
    asked = []
    plain = ref.flash_attention_plain

    def recording(*a, **kw):
        asked.append(kw.get("return_stats", False))
        return plain(*a, **kw)

    monkeypatch.setattr(ref, "flash_attention_plain", recording)
    arrs = _inputs(6, 1, 2, 1, 64, 64, 32)
    q, k, v = (_t(a, grad=True) for a in arrs[:3])
    with torch.no_grad():
        plain_out = ops.flash_attention(q, k, v)
    grad_out = ops.flash_attention(q, k, v)
    assert asked == [False, True]
    assert torch.equal(plain_out, grad_out.detach())
    assert grad_out.grad_fn is not None


def _specs(shapes, dtype=torch.bfloat16, d_stride=1):
    strides = [(s[1] * s[2] * s[3], s[2] * s[3], s[3], d_stride) for s in shapes]
    return dtype, shapes, strides, [0] * len(shapes)


_Q, _KV = (1, 4, 128, 64), (1, 2, 128, 64)


@pytest.mark.parametrize("dtype,route", [(torch.float32, "simt"),
                                         (torch.bfloat16, "mma"),
                                         (torch.float16, "mma")])
def test_backward_route_is_fixed_by_dtype(dtype, route):
    assert kernel.bwd_launch_plan(*_specs([_Q, _KV, _KV, _Q, _Q], dtype)) == route


@pytest.mark.parametrize("shapes,match", [
    ([_Q, _KV, _KV, (1, 4, 64, 64), _Q], "o .* is not shaped like q"),
    ([_Q, _KV, _KV, _Q, (1, 4, 128, 32)], "dO .* is not shaped like q"),
    ([(1, 4, 128, 48), (1, 2, 128, 48), (1, 2, 128, 48)] + [(1, 4, 128, 48)] * 2,
     "head dim D"),
    ([(1, 3, 128, 64), _KV, _KV, (1, 3, 128, 64), (1, 3, 128, 64)], "multiple of Hkv"),
])
def test_backward_plan_refuses_bad_shapes(shapes, match):
    for dtype in (torch.float32, torch.bfloat16):
        with pytest.raises(ValueError, match=match):
            kernel.bwd_launch_plan(*_specs(shapes, dtype))


def test_backward_plan_refuses_other_dtypes_and_strides():
    with pytest.raises(ValueError, match="float32, bfloat16"):
        kernel.bwd_launch_plan(*_specs([_Q, _KV, _KV, _Q, _Q], torch.float64))
    dtype, shapes, strides, ptrs = _specs([_Q, _KV, _KV, _Q, _Q])
    strides[4] = (*strides[4][:3], 2)
    with pytest.raises(ValueError, match="unit stride"):
        kernel.bwd_launch_plan(dtype, shapes, strides, ptrs)


def test_tensor_core_backward_needs_16_byte_rows():
    """The tensor-core route loads rows with 16-byte loads: a data pointer
    or a stride off the 16-byte grid raises there, and the CUDA-core route
    (f32, scalar loads) takes it."""
    dtype, shapes, strides, ptrs = _specs([_Q, _KV, _KV, _Q, _Q])
    with pytest.raises(ValueError, match="16-byte aligned"):
        kernel.bwd_launch_plan(dtype, shapes, strides, [0, 0, 0, 0, 2])
    odd = list(strides)
    odd[3] = (odd[3][0], odd[3][1], 65, 1)  # an o row stride of 130 bytes
    with pytest.raises(ValueError, match="multiple of 16 bytes"):
        kernel.bwd_launch_plan(dtype, shapes, odd, ptrs)
    assert kernel.bwd_launch_plan(torch.float32, shapes, odd, [0, 0, 0, 0, 4]) == "simt"


def test_backward_statistics_checks():
    m = torch.zeros((1, 4, 128))
    kernel.check_stats((1, 4, 128), m, m.clone())
    with pytest.raises(ValueError, match="m must be contiguous float32"):
        kernel.check_stats((1, 4, 128), m.double(), m)
    with pytest.raises(ValueError, match="l must be contiguous float32"):
        kernel.check_stats((1, 4, 128), m, torch.zeros((1, 4, 64)))
    with pytest.raises(ValueError, match="l must be contiguous float32"):
        kernel.check_stats((1, 4, 128), m, torch.zeros((1, 128, 4)).transpose(1, 2))


def test_backward_wrapper_refuses_cpu_tensors():
    arrs = _inputs(7, 1, 2, 1, 64, 64, 32)
    q, k, v, do = (_t(a) for a in arrs)
    out, m, l = ref.flash_attention_plain(q, k, v, return_stats=True)
    before = kernel.flash_attention_bwd.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernel.flash_attention_bwd(q, k, v, out, m, l, do)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernel.flash_attention(q, k, v, stats=True)
    assert kernel.flash_attention_bwd.launches == before


# the training shape: q (2, 14, 8192, 64), k and v (2, 2, 8192, 64)
_TRAIN = (2, 14, 2, 8192, 8192, 64)


def test_tensor_core_backward_scratch():
    """bfloat16 and float16: the rows' statistics (3 planes, Sq rounded up
    to 4 so that every q tile's are 16-byte copies) and each q head's f32
    dk and dv partials; float32 keeps its one Delta plane."""
    B, Hq, Hkv, Sq, Sk, D = _TRAIN
    for dtype in (torch.bfloat16, torch.float16):
        scratch = kernel.bwd_scratch(dtype, *_TRAIN)
        assert scratch == {"rows": ((3, B, Hq, Sq), torch.float32),
                           "dk_part": ((B, Hq, Sk, D), torch.float32),
                           "dv_part": ((B, Hq, Sk, D), torch.float32)}
        nbytes = {name: 4 * int(np.prod(shape)) for name, (shape, _) in scratch.items()}
        assert nbytes == {"rows": 2_752_512, "dk_part": 58_720_256, "dv_part": 58_720_256}
    assert kernel.bwd_scratch(torch.bfloat16, 1, 7, 1, 13, 9, 32)["rows"][0] == (3, 1, 7, 16)
    # paligemma-3b's layer (hd256p): q (2, 8, 8192, 256), k = v (2, 1, 8192, 256)
    wide = kernel.bwd_scratch(torch.bfloat16, 2, 8, 1, 8192, 8192, 256)
    assert {name: 4 * int(np.prod(shape)) for name, (shape, _) in wide.items()} == {
        "rows": 1_572_864, "dk_part": 134_217_728, "dv_part": 134_217_728}
    assert kernel.bwd_scratch(torch.float32, *_TRAIN) == {
        "delta": ((B, Hq, Sq), torch.float32)}


def test_per_tile_limit_sees_what_the_whole_tensor_limit_misses():
    """chip_smoke.py's second backward limit takes max|want| per 64-row tile
    of each (batch, head): an error in a tile whose gradient is small (the
    last rows' dq, the last key tile's dk) passes the whole-tensor limit and
    fails this one; the kernel's own rounding passes both."""
    import chip_smoke

    rng = np.random.default_rng(11)
    want = torch.from_numpy(rng.standard_normal((2, 3, 200, 32))).to(torch.bfloat16)
    want[:, :, 128:] *= 1e-3  # the last two tiles' gradient is small; 200 rows: one ragged
    wrong = want.clone()
    wrong[1, 2, 190:] = 0
    assert chip_smoke._bwd_tol_ratio(wrong, want) <= 1 < chip_smoke._bwd_tile_ratio(wrong, want)
    # one bf16 ulp off, everywhere: within both limits
    ulp = (want.float() * (1 + 2.0 ** -8)).to(torch.bfloat16)
    assert chip_smoke._bwd_tol_ratio(ulp, want) <= 1
    assert chip_smoke._bwd_tile_ratio(ulp, want) <= 1
    assert chip_smoke._bwd_tile_ratio(want, want) == 0
    zero = torch.zeros_like(want)
    zero[0, 0, 199] = 1  # an error where the whole tile is 0
    assert chip_smoke._bwd_tile_ratio(zero, torch.zeros_like(want)) == float("inf")


def test_ptxas_report_reads_each_kernel(tmp_path):
    """The assembler's report kept beside a built library: each kernel's
    name and template arguments out of its mangled name, its registers and
    its spills."""
    from repro_torch.kernels import _build

    ns = "_GLOBAL__N__3b49a283_22_flash_attention_bwd_cu_04843d30"
    log = "\n".join([
        "ptxas info    : 0 bytes gmem",
        f"ptxas info    : Compiling entry function '_ZN{len(ns)}{ns}16flash_bwd_dq_mma"
        f"I13__nv_bfloat16Li64EEEvNS_6ParamsE' for 'sm_90a'",
        "ptxas info    : Function properties for x",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 128 registers, used 1 barriers, 384 bytes cmem[0]",
        f"ptxas info    : Compiling entry function '_ZN{len(ns)}{ns}21flash_bwd_reduce_dkdv"
        f"I6__halfEEvNS_6ParamsE' for 'sm_90a'",
        "ptxas info    : Function properties for y",
        "    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads",
        "ptxas info    : Used 255 registers, used 0 barriers, 384 bytes cmem[0]",
    ])
    (tmp_path / "libx.log").write_text(log)
    assert _build.ptxas_report(tmp_path / "libx.so") == [
        {"kernel": "flash_bwd_dq_mma", "dtype": "bf16", "d": 64, "stack": 0,
         "spill_stores": 0, "spill_loads": 0, "registers": 128},
        {"kernel": "flash_bwd_reduce_dkdv", "dtype": "f16", "d": None, "stack": 8,
         "spill_stores": 4, "spill_loads": 4, "registers": 255},
    ]
