"""The f32 route of the encoder's wide convolutions (``csrc/conv_f32.cu``,
``ops/kernels/conv.conv1d_f32``, ``models/encoder.F32Conv1d``).

On the CPU: the plain versions against float64 convolutions; the shape rule
that gives a layer to the kernels; the work plans (groups and blocks of the
forward, slices and chunks of the weight gradient) within the card's
limits; a numpy transcription of both kernels' index maps (the weights
staged centred and, for the input gradient, read tap-flipped in place; the
strips with their halo; each lane's window; dy transposed as staged; the
scratch in thread order and its fixed-order reduce) held against float64;
the encoder's parameters, initialisation and CPU outputs bit-equal to an
encoder built of plain ``nn.Conv1d`` layers; the launch counters. The
tests marked ``cuda`` hold the kernels against float64 and cuDNN on the
card and skip elsewhere.

Tolerances: the plain versions are f32 sums of at most 600 products (dW:
~10^3), held within 1e-5 of the float64 result's max; the transcriptions
sum in float64, so they match float64 to 1e-9 unless an index is wrong.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from sot_tpu_torch.models import encoder as encoder_mod
from sot_tpu_torch.models.encoder import F32Conv1d, PESTOEncoder
from sot_tpu_torch.ops.kernels import conv as kconv
from sot_tpu_torch.ops.kernels import launches as launches_lib

TAPS, STRIP, XS, CD = kconv.F32_TAPS, kconv.F32_STRIP, kconv.F32_XS, kconv.F32_CD
DSTRIP, DXS = kconv.F32_DSTRIP, kconv.F32_DXS
SPAN = STRIP + TAPS - 1
PT = STRIP // 32

# (rows, C_in, C_out, width, k): the encoder's conv1, prefilter and conv1's
# input gradient, widths that do not divide the strip or span two strips,
# the smallest shapes
SHAPES = [(3, 1, 40, 285, 15), (3, 40, 40, 285, 15), (2, 40, 1, 285, 15),
          (2, 3, 5, 300, 5), (4, 3, 3, 29, 3), (1, 1, 1, 1, 15), (2, 40, 3, 577, 15)]


def _case(rows, cin, cout, width, k, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, cin, width)).astype(np.float32)
    w = (rng.standard_normal((cout, cin, k)) / np.sqrt(cin * k)).astype(np.float32)
    b = rng.standard_normal(cout).astype(np.float32)
    dy = rng.standard_normal((rows, cout, width)).astype(np.float32)
    return tuple(torch.from_numpy(a) for a in (x, w, b, dy))


def _f64_refs(x, w, b, dy):
    """Forward (with bias), dx and dW of the 'same' conv in float64."""
    x64, w64, b64, dy64 = (t.double().requires_grad_(True) for t in (x, w, b, dy))
    y = F.conv1d(x64, w64, b64, padding=(w.shape[-1] - 1) // 2)
    dx, dw = torch.autograd.grad(y, (x64, w64), dy64)
    return y.detach(), dx, dw


def _rel(got, ref) -> float:
    return float((got.double() - ref).abs().max() / ref.abs().max().clamp(min=1e-30))


# -- plain versions ------------------------------------------------------------

@pytest.mark.parametrize("k", [3, 5, 15])
@pytest.mark.parametrize("cin,cout", [(1, 40), (40, 40), (40, 1), (3, 3), (1, 3)])
@pytest.mark.parametrize("width", [37, 285, 301])
def test_plain_versions_match_float64(k, cin, cout, width):
    x, w, b, dy = _case(2, cin, cout, width, k, seed=k + cin + width)
    y64, dx64, dw64 = _f64_refs(x, w, b, dy)
    before = (kconv.f32_launches, kconv.f32_dw_launches)
    y = kconv.conv1d_f32_forward(x, w, b)
    dx = kconv.conv1d_f32_forward(dy, w, None, transposed=True)
    dw = kconv.conv1d_f32_weight(x, dy, k)
    assert (kconv.f32_launches, kconv.f32_dw_launches) == before  # the CPU launches nothing
    assert y.shape == (2, cout, width) and dx.shape == x.shape and dw.shape == w.shape
    for got, ref in ((y, y64), (dx, dx64), (dw, dw64)):
        assert got.dtype == torch.float32
        assert _rel(got, ref) <= 1e-5


def test_plain_forward_is_f_conv1d_and_autograd_matches():
    x, w, b, dy = _case(3, 40, 40, 285, 15, seed=4)
    assert torch.equal(kconv.conv1d_f32_forward(x, w, b), F.conv1d(x, w, b, padding=7))
    leaves = [t.clone().requires_grad_(True) for t in (x, w, b)]
    kconv.conv1d_f32(*leaves).backward(dy)
    ref = [t.clone().requires_grad_(True) for t in (x, w, b)]
    F.conv1d(*ref, padding=7).backward(dy)
    for got, want in zip(leaves, ref):
        assert _rel(got.grad, want.grad.double()) <= 1e-5
    # the bias gradient is dy summed over rows and bins
    assert torch.equal(leaves[2].grad, dy.sum((0, 2)))


def test_autograd_without_bias_and_frozen_input():
    x, w, _, dy = _case(2, 1, 40, 285, 15, seed=5)
    w = w.requires_grad_(True)
    y = kconv.conv1d_f32(x, w)
    y.backward(dy)
    assert x.grad is None
    assert _rel(w.grad, torch.nn.grad.conv1d_weight(x.double(), tuple(w.shape), dy.double(),
                                                    padding=7)) <= 1e-5


# -- the shape rule --------------------------------------------------------------

@pytest.mark.parametrize("args,kwargs,takes", [
    ((15, 1, 40), {}, True),
    ((15, 40, 40), {}, True),
    ((15, 40, 1), {}, True),
    ((3, 1, 1), {}, True),
    ((15, 40, 40), {"padding": 7}, True),
    ((1, 40, 30), {}, False),            # the 1x1 convolutions stay on cuDNN
    ((17, 40, 40), {}, False),           # k above 15
    ((14, 40, 40), {}, False),           # even k
    ((15, 41, 40), {}, False),           # C_in above the limit
    ((15, 40, 41), {}, False),           # C_out above the limit
    ((15, 0, 40), {}, False),
    ((15, 40, 40), {"padding": 0}, False),
    ((15, 40, 40), {"stride": 2}, False),
    ((15, 40, 40), {"dilation": 2}, False),
    ((15, 40, 40), {"groups": 2}, False),
    ((15, 40, 40), {"padding_mode": "reflect"}, False),
])
def test_f32_route_shape_rule(args, kwargs, takes):
    assert kconv.f32_route(*args, **kwargs) is takes


# -- the work plans --------------------------------------------------------------

PLAN_SHAPES = [(1024, 285, 40, 40), (1024, 285, 1, 40), (1024, 285, 40, 1), (64, 285, 40, 40),
               (1, 1, 1, 1), (7, 600, 3, 5), (2048, 129, 40, 40), (3, 285, 40, 4)]


@pytest.mark.parametrize("rows,width,cin,cout", PLAN_SHAPES)
@pytest.mark.parametrize("n_sm", [1, 2, 132])
def test_fwd_plan_within_card_limits(rows, width, cin, cout, n_sm):
    groups, blocks = kconv.f32_fwd_plan(rows, width, cin, cout, n_sm)
    ct = kconv.f32_channels_per_warp(cout)
    threads = groups * 32 * -(-cout // ct)
    items = rows * kconv.f32_strips(width)
    assert 1 <= groups <= min(kconv.F32_MAX_GROUPS, items)
    assert threads <= kconv.F32_FWD_THREADS[ct]
    assert kconv.f32_fwd_smem(cin, cout, groups) <= kconv.SMEM_MAX
    assert blocks == min(n_sm, -(-items // groups))
    # every item is taken by exactly one (block, group) of the persistent walk
    taken = np.zeros(items, int)
    for b in range(blocks):
        for g in range(groups):
            taken[b * groups + g::blocks * groups] += 1
    assert (taken == 1).all()


def test_fwd_plan_at_the_encoder_shapes():
    assert kconv.f32_fwd_plan(1024, 285, 40, 40, 132) == (2, 132)   # prefilter, its dx
    assert kconv.f32_fwd_plan(1024, 285, 1, 40, 132) == (2, 132)    # conv1
    assert kconv.f32_fwd_plan(1024, 285, 40, 1, 132) == (4, 132)    # conv1's dx
    assert kconv.f32_fwd_smem(40, 40, 2) == 192960


@pytest.mark.parametrize("rows,width,cin,cout", PLAN_SHAPES)
@pytest.mark.parametrize("n_sm", [1, 2, 132])
def test_dw_plan_runs_cover_items(rows, width, cin, cout, n_sm):
    slices, per, blocks = kconv.f32_dw_plan(rows, width, cin, cout, n_sm)
    items = rows * kconv.f32_dw_strips(width)
    threads = slices * cin * -(-cout // CD)
    assert (DSTRIP // 9) % slices == 0 and threads <= kconv.F32_DW_THREADS
    assert 2 * threads > kconv.F32_DW_THREADS or slices == DSTRIP // 9
    assert kconv.f32_dw_smem(cin, cout, slices) <= kconv.SMEM_MAX
    assert blocks <= kconv.f32_dw_blocks_per_sm(cin, cout) * n_sm
    assert (blocks - 1) * per < items <= blocks * per
    assert kconv.f32_dw_scratch(cin, cout, blocks) == blocks * CD * TAPS * (threads // slices)


@pytest.mark.parametrize("cin", range(1, 41))
@pytest.mark.parametrize("cout", [1, 4, 5, 17, 40])
def test_smem_fits_every_shape(cin, cout):
    slices = kconv.f32_dw_slices(cin, cout)
    assert kconv.f32_dw_smem(cin, cout, slices) <= kconv.SMEM_MAX
    groups, _ = kconv.f32_fwd_plan(1024, 285, cin, cout, 132)
    assert kconv.f32_fwd_smem(cin, cout, groups) <= kconv.SMEM_MAX


def test_dw_plan_at_the_encoder_shapes():
    assert kconv.f32_dw_plan(1024, 285, 40, 40, 132) == (1, 16, 128)   # prefilter
    assert kconv.f32_dw_plan(1024, 285, 1, 40, 132) == (16, 8, 256)    # conv1: two an SM
    assert kconv.f32_dw_smem(40, 40, 1) == 202176


# -- transcriptions of the kernels' index maps -------------------------------------

def _stage_strip(xr: np.ndarray, w0: int) -> np.ndarray:
    """[C, XS] of one row's strip from bin w0 - 7, zeros outside the row."""
    cin, width = xr.shape
    xs = np.full((cin, XS), np.nan)
    p = w0 + np.arange(SPAN) - (TAPS - 1) // 2
    ok = (p >= 0) & (p < width)
    xs[:, :SPAN] = 0.0
    xs[:, np.arange(SPAN)[ok]] = xr[:, p[ok]]
    return xs


def emulate_fwd(x, weight, bias, transposed=False, n_sm=3):
    """The forward kernel on x [B, C_in, W]: weight [C_out, C_in, k], or
    with ``transposed`` [C_in, C_out, k] read tap-flipped (float64 sums)."""
    x, weight = x.double().numpy(), weight.double().numpy()
    rows, cin, width = x.shape
    cout = weight.shape[1] if transposed else weight.shape[0]
    k = weight.shape[-1]
    ct = kconv.f32_channels_per_warp(cout)
    n_cg = -(-cout // ct)
    cp = n_cg * ct
    off = (TAPS - k) // 2
    ws = np.zeros((cin, TAPS, cp))   # [ci][d][co], as staged
    for i in range(cin * TAPS * cp):
        co, t = i % cp, i // cp
        d, ci = t % TAPS, t // TAPS
        dk = d - off
        if co < cout and 0 <= dk < k:
            ws[ci, d, co] = (weight[ci, co, k - 1 - dk] if transposed
                             else weight[co, ci, dk])
    groups, blocks = kconv.f32_fwd_plan(rows, width, cin, cout, n_sm)
    n_strips = kconv.f32_strips(width)
    y = np.full((rows, cout, width), np.nan)
    lane = np.arange(32)
    win = lane[:, None, None] * PT + np.arange(PT)[None, :, None] + np.arange(TAPS)[None, None]
    for b in range(blocks):
        for g in range(groups):
            for item in range(b * groups + g, rows * n_strips, blocks * groups):
                r, s = divmod(item, n_strips)
                w0 = s * STRIP
                xs = _stage_strip(x[r], w0)
                # acc[lane, i, co] = sum_ci sum_d xs[ci, 9 lane + i + d] ws[ci, d, co]
                acc = np.einsum("clid,cdo->lio", xs[:, win], ws)
                ys = np.zeros((cp, STRIP))
                for cg in range(n_cg):
                    for c in range(ct):
                        ys[cg * ct + c] = acc[:, :, cg * ct + c].reshape(-1)
                n = min(STRIP, width - w0)
                add = bias.double().numpy()[:, None] if bias is not None else 0.0
                y[r, :, w0:w0 + n] = ys[:cout, :n] + add
    return torch.from_numpy(y)


def dy_transpose_map(cps: int):
    """(slot, j) of each flat index e of the weight gradient's dy staging:
    slot s holds channel (s // 6) * 5 + s % 6 (none where s % 6 == 5)."""
    e = np.arange(cps * DSTRIP)
    rest = e >> 5
    slot = (rest // (DSTRIP // 8)) * 4 + (e & 3)
    j = (rest % (DSTRIP // 8)) * 8 + ((e >> 2) & 7)
    return slot, j


def emulate_dw(x, dy, k, n_sm=3):
    """The weight gradient's two kernels on x [B, C_in, W], dy [B, C_out, W]
    (float64 sums)."""
    x, dy = x.double().numpy(), dy.double().numpy()
    rows, cin, width = x.shape
    cout = dy.shape[1]
    n_cg = -(-cout // CD)
    cps = -(-n_cg * kconv.F32_CDP // 4) * 4
    slices, per, blocks = kconv.f32_dw_plan(rows, width, cin, cout, n_sm)
    t1n = cin * n_cg
    nt = slices * t1n
    slice_len = DSTRIP // slices
    n_strips = kconv.f32_dw_strips(width)
    items = rows * n_strips
    tid = np.arange(nt)
    cg, t1 = tid % n_cg, tid % t1n
    ci, sl = t1 // n_cg, tid // t1n
    slot_map, j_map = dy_transpose_map(cps)
    n = CD * TAPS * t1n
    cd_of = np.arange(CD)[:, None] * TAPS + np.arange(TAPS)[None]   # [c, d] -> c * 15 + d
    partial = np.full((blocks, n), np.nan)
    walked = []
    for b in range(blocks):
        sums = np.zeros((CD * TAPS, nt))   # [c * 15 + d][tid], as in shared memory
        for item in range(b * per, min(items, (b + 1) * per)):
            walked.append(item)
            r, strip = divmod(item, n_strips)
            w0 = strip * DSTRIP
            xs = np.full((cin, DXS), np.nan)
            p = w0 + np.arange(DSTRIP + TAPS - 1) - (TAPS - 1) // 2
            ok = (p >= 0) & (p < width)
            xs[:, :DSTRIP + TAPS - 1] = 0.0
            xs[:, np.arange(DSTRIP + TAPS - 1)[ok]] = x[r][:, p[ok]]
            ds = np.full((DSTRIP, cps), np.nan)
            c_of, co_of = slot_map % kconv.F32_CDP, (slot_map // kconv.F32_CDP) * CD + \
                slot_map % kconv.F32_CDP
            ok = (c_of < CD) & (co_of < cout) & (w0 + j_map < width)
            ds[j_map, slot_map] = 0.0
            ds[j_map[ok], slot_map[ok]] = dy[r, co_of[ok], w0 + j_map[ok]]
            for t in range(nt):
                q = sl[t] * slice_len + np.arange(slice_len)
                base = cg[t] * kconv.F32_CDP
                dv = ds[q][:, base:base + CD]                       # [positions, CD]
                xw = xs[ci[t]][q[:, None] + np.arange(TAPS)[None]]  # [positions, TAPS]
                sums[cd_of, t] += dv.T @ xw
        h = slices // 2
        while h >= 1:   # slices added pairwise
            sums[:, :h * t1n] += sums[:, h * t1n:2 * h * t1n]
            h //= 2
        partial[b] = sums[:, :t1n].reshape(-1)   # [c * 15 + d][t1]
    assert sorted(walked) == list(range(items))
    total = sum(partial[g::8].sum(axis=0) for g in range(8))
    dw = np.full((cout, cin, k), np.nan)
    written = np.zeros((cout, cin, k), int)
    for o in range(n):
        t1o, cd = o % t1n, o // t1n
        co = (t1o % n_cg) * CD + cd // TAPS
        cio, dk = t1o // n_cg, cd % TAPS - (TAPS - k) // 2
        if co >= cout or dk < 0 or dk >= k:
            continue
        dw[co, cio, dk] = total[o]
        written[co, cio, dk] += 1
    assert (written == 1).all()
    return torch.from_numpy(dw)


@pytest.mark.parametrize("cps", [4, 12, 20, 32, 40])
def test_dy_staging_map_is_a_bijection(cps):
    co, j = dy_transpose_map(cps)
    seen = np.zeros((DSTRIP, cps), int)
    np.add.at(seen, (j, co), 1)
    assert (seen == 1).all()
    # a warp's 32 lanes: 4 channels x 8 consecutive bins
    assert set(co[:32]) == {0, 1, 2, 3} and set(j[:32]) == set(range(8))


@pytest.mark.parametrize("rows,cin,cout,width,k", SHAPES)
def test_forward_transcription_matches_float64(rows, cin, cout, width, k):
    x, w, b, dy = _case(rows, cin, cout, width, k, seed=rows + cin + width)
    y64, dx64, _ = _f64_refs(x, w, b, dy)
    y = emulate_fwd(x, w, b)
    assert not torch.isnan(y).any()
    assert _rel(y, y64) <= 1e-9
    # the input gradient: dy through the same kernel, the weight read in place
    dx = emulate_fwd(dy, w, None, transposed=True)
    assert _rel(dx, dx64) <= 1e-9


@pytest.mark.parametrize("rows,cin,cout,width,k", SHAPES)
def test_weight_transcription_matches_float64(rows, cin, cout, width, k):
    x, w, b, dy = _case(rows, cin, cout, width, k, seed=2 * rows + cin + width)
    _, _, dw64 = _f64_refs(x, w, b, dy)
    assert _rel(emulate_dw(x, dy, k), dw64) <= 1e-9


# -- the encoder -------------------------------------------------------------------

def _plain_wide(cin, cout, k):
    return nn.Conv1d(cin, cout, k, padding=(k - 1) // 2)


def _encoders(monkeypatch, seed=7):
    torch.manual_seed(0)
    enc = PESTOEncoder(generator=torch.Generator().manual_seed(seed))
    with monkeypatch.context() as m:
        m.setattr(encoder_mod, "F32Conv1d", _plain_wide)
        torch.manual_seed(0)
        ref = PESTOEncoder(generator=torch.Generator().manual_seed(seed))
    return enc, ref


def test_encoder_wide_convs_are_f32_layers():
    enc = PESTOEncoder()
    wide = [enc.conv1, *enc.prefilt]
    assert all(type(m) is F32Conv1d for m in wide)
    assert all(type(m) is nn.Conv1d for m in (enc.conv2, enc.conv3, enc.conv4a, enc.conv4b))
    assert all(kconv.f32_route(m.kernel_size[0], m.in_channels, m.out_channels, m.stride[0],
                               m.padding[0], m.dilation[0], m.groups, m.padding_mode)
               for m in wide)
    gated = PESTOEncoder(conv_dtype=torch.float32)
    assert type(gated.conv1) is encoder_mod.KernelConv1d
    bf16 = PESTOEncoder(conv_bf16=True)
    assert type(bf16.conv1) is encoder_mod.Bf16Conv1d


def test_encoder_state_and_cpu_outputs_bit_equal_to_plain_conv1d(monkeypatch):
    enc, ref = _encoders(monkeypatch)
    assert type(ref.conv1) is nn.Conv1d
    sd, sd_ref = enc.state_dict(), ref.state_dict()
    assert list(sd) == list(sd_ref)
    assert all(torch.equal(sd[k], sd_ref[k]) for k in sd)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((6, 285)).astype(np.float32))
    before = launches_lib.read()
    out, out_ref = enc.eval()(x), ref.eval()(x)
    assert launches_lib.read() == before  # no launch on the CPU
    assert out.keys() == out_ref.keys()
    assert all(torch.equal(out[k], out_ref[k]) for k in out)
    (out["frequency"].sum() + out["weights"].sum()).backward()
    (out_ref["frequency"].sum() + out_ref["weights"].sum()).backward()
    grads = dict(enc.named_parameters())
    for name, p in ref.named_parameters():
        assert torch.equal(grads[name].grad, p.grad), name


def test_encoder_loads_a_plain_conv1d_state_dict(monkeypatch):
    enc, ref = _encoders(monkeypatch, seed=8)
    fresh = PESTOEncoder(generator=torch.Generator().manual_seed(9))
    fresh.load_state_dict(ref.state_dict())
    assert all(torch.equal(a, b) for a, b in zip(fresh.state_dict().values(),
                                                 enc.state_dict().values()))


@pytest.mark.parametrize("cin,cout,k", [(41, 40, 15), (40, 41, 15), (3, 3, 17)])
def test_layer_outside_the_rule_is_plain_conv1d_on_cpu(cin, cout, k):
    """On the CPU every F32Conv1d is nn.Conv1d's forward, also a layer the
    kernels' rule does not take (that layer raises on the card)."""
    layer = F32Conv1d(cin, cout, k)
    assert not kconv.f32_route(k, cin, cout)
    plain = _plain_wide(cin, cout, k)
    plain.load_state_dict(layer.state_dict())
    x = torch.randn(2, cin, 33, generator=torch.Generator().manual_seed(k))
    assert torch.equal(layer(x), plain(x))


# -- the counters -------------------------------------------------------------------

def test_counters_registered_and_round_trip():
    names = {"conv1d_f32_forward": "f32_launches", "conv1d_f32_weight": "f32_dw_launches"}
    saved = launches_lib.read()
    try:
        for name, attr in names.items():
            assert launches_lib.COUNTERS[name] == (kconv, attr)
        launches_lib.write({"conv1d_f32_forward": 4, "conv1d_f32_weight": 2})
        got = launches_lib.read()
        assert (got["conv1d_f32_forward"], got["conv1d_f32_weight"]) == (4, 2)
        assert (kconv.f32_launches, kconv.f32_dw_launches) == (4, 2)
        launches_lib.add(launches_lib.delta(saved, got), 3)
        assert launches_lib.read()["conv1d_f32_forward"] == 4 + 3 * (4 - saved[
            "conv1d_f32_forward"])
        launches_lib.reset()
        assert all(v == 0 for v in launches_lib.read().values())
    finally:
        launches_lib.write(saved)


def test_wrappers_reject_other_devices():
    x, w, b, dy = _case(2, 40, 40, 285, 15)
    with pytest.raises(ValueError, match="conv1d_f32_forward"):
        kconv.conv1d_f32_forward(x.to("meta"), w.to("meta"))
    with pytest.raises(ValueError, match="conv1d_f32_weight"):
        kconv.conv1d_f32_weight(x.to("meta"), dy.to("meta"), 15)


# -- on the card -----------------------------------------------------------------------

def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout", [(1, 40), (40, 40), (40, 1)])
def test_kernels_float64_close_and_bit_equal_on_card(cin, cout):
    """At the encoder's shapes ([1024, C, 285], k = 15): each pass within
    2x cuDNN f32's error against float64, and two launches bit-equal."""
    _need_cuda()
    from sot_tpu_torch.device import set_precision_policy

    set_precision_policy()
    x, w, b, dy = (t.cuda() for t in _case(1024, cin, cout, 285, 15, seed=cin))
    y64, dx64, dw64 = _f64_refs(x, w, b, dy)

    def passes():
        return (kconv.conv1d_f32_forward(x, w, b),
                kconv.conv1d_f32_forward(dy, w, None, transposed=True),
                kconv.conv1d_f32_weight(x, dy, 15))

    got, again = passes(), passes()
    lib = (F.conv1d(x, w, b, padding=7),
           F.conv1d(dy, w.flip(-1).transpose(0, 1), padding=7),
           torch.nn.grad.conv1d_weight(x, tuple(w.shape), dy, padding=7))
    torch.cuda.synchronize()
    assert all(torch.equal(a, c) for a, c in zip(got, again))
    for g, ref, r64 in zip(got, lib, (y64, dx64, dw64)):
        assert _rel(g, r64) <= 2.0 * _rel(ref, r64)


@pytest.mark.cuda
def test_encoder_takes_the_kernels_on_card():
    """Forward and backward of the default encoder on the card: 4 forward-
    kernel launches (conv1, prefilter, their input gradients) and 2 weight
    gradients, and the gradients close to the same encoder on
    cuDNN (plain nn.Conv1d layers, TF32 off)."""
    _need_cuda()
    from sot_tpu_torch.device import set_precision_policy

    set_precision_policy()
    enc = PESTOEncoder(generator=torch.Generator().manual_seed(3)).cuda().eval()
    ref = PESTOEncoder(generator=torch.Generator().manual_seed(3)).cuda().eval()
    ref.conv1 = _plain_wide(1, 40, 15).cuda()
    ref.prefilt = nn.ModuleList([_plain_wide(40, 40, 15).cuda()])
    ref.load_state_dict(enc.state_dict())
    x = torch.randn(1024, 285, device="cuda", generator=torch.Generator("cuda").manual_seed(0))
    before = launches_lib.read()
    out = enc(x)
    (out["frequency"].square().sum() + out["weights"].sum()).backward()
    torch.cuda.synchronize()
    d = launches_lib.delta(before, launches_lib.read())
    assert (d["conv1d_f32_forward"], d["conv1d_f32_weight"]) == (4, 2)
    out_ref = ref(x)
    (out_ref["frequency"].square().sum() + out_ref["weights"].sum()).backward()
    for k in out:
        assert _rel(out[k], out_ref[k].double()) <= 1e-5
    grads = dict(ref.named_parameters())
    for name, p in enc.named_parameters():
        assert _rel(p.grad, grads[name].grad.double()) <= 1e-3, name


@pytest.mark.cuda
def test_layer_outside_the_rule_raises_on_card():
    """On the card a layer the rule does not take raises instead of running
    on another kernel."""
    _need_cuda()
    layer = F32Conv1d(41, 40, 15).cuda()
    with pytest.raises(ValueError, match="F32Conv1d"):
        layer(torch.zeros(2, 41, 33, device="cuda"))
