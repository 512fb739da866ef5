"""K11's int8 wgmma dataflow (csrc/plain_w8a8.cu), modelled in NumPy on the
CPU, where no CUDA kernel runs; the swizzle and accumulator model is
tests/test_torch_dense_wgmma.py's, extended to 1-byte elements.

- Staging: int8 layers (nf rows x nf) and the output head (64 rows x nf)
  in 128-byte-swizzled K-blocks of 128 columns, read back at the
  addresses a wgmma descriptor gives, per k32 step and n128 half.
- Fragments: wgmma m64nNk32's int8 A fragment (mma.sync m16n8k32's per
  warp) and the s32 accumulator (the float32 one's positions); the
  kernel's head writes each feature's code where the first layer's A
  reads it under `quant.k32_feature_order`, and its requant packs each
  layer's accumulator, as it lies, into the next layer's A.
- Each layer (nf=128 and 256, depth 1-3, "int" and "f32") through
  fragments, descriptors and the requant equals the plain product and
  `unit_kernel._q8_requant`; a whole mode equals
  `stage_ensemble_apply_q_plain`.
- The exact tricks: float(a) as bits(a + 1.5 * 2^23) - 1.5 * 2^23 over
  |a| <= 127 * 127 * nf; the head's codes from min(x, 127) + 128 in bf16
  over every bf16 value.
- Shared memory, launch geometry and staged bytes: chip_smoke's and the
  wrapper's copies equal the source's; `_Q8Desc` mirrors `Q8Params`.
"""

import functools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke as cs
from mulut_tpu_torch.ops import quant as tq
from mulut_tpu_torch.ops import unit_kernel as tuk
from tests.test_torch_dense_wgmma import _struct_fields, d_coords, sw128

CSRC = Path(tuk.__file__).resolve().parent / "csrc"
SRC = (CSRC / "plain_w8a8.cu").read_text()
CODE = re.sub(r"//[^\n]*", "", SRC)
SMEM_MAX = 232_448               # H100: a block's opt-in shared memory
BATCH_CALL = 3_110_400           # a K11 call's sites: 8 x 3 x 270 x 480 / 2
RAGGED = (1, 63, 64, 65, 767, 769, 1_000_003, BATCH_CALL)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's CPU ops on one thread while this module runs: its many
    small ops under the suite's worker processes otherwise spend their
    time in OpenMP barriers of oversubscribed cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _constants():
    """The `constexpr int` values of net_common.cuh and plain_w8a8.cu."""
    env = {}
    for text in ((CSRC / "net_common.cuh").read_text(), SRC):
        text = re.sub(r"//[^\n]*", "", text)
        for key, expr in re.findall(r"^constexpr int (\w+) = ([^;]+);", text,
                                    re.M):
            env[key] = int(eval(expr.replace("/", "//"), {}, dict(env)))
    return env


C = _constants()


# --- the model -------------------------------------------------------------


def stage_s8(smem, base, src, kblock):
    """`stage_sw128` over int8: (rows, K) bytes into swizzled K-blocks
    kblock bytes apart at base, 16-byte chunk c of row r at sw128."""
    rows, K = src.shape
    r = np.arange(rows)[:, None]
    byte = np.arange(16)[None, :]
    for c in range(K // 16):
        smem[base + sw128(r, c, kblock) + byte] = \
            src[:, 16 * c: 16 * c + 16].view(np.uint8)


def descriptor_read_s8(smem, start, N):
    """The 32 x N int8 B tile (as [n][k]) a K-major 128B-swizzled
    descriptor at byte address `start` reads: row n, column k at start +
    (n // 8) * 1024 + (n % 8) * 128 + k, the address bits [4, 7) XORed
    with bits [7, 10)."""
    n, k = np.meshgrid(np.arange(N), np.arange(32), indexing="ij")
    addr = start + (n // 8) * 1024 + (n % 8) * 128 + k
    phys = addr ^ (((addr >> 7) & 7) << 4)
    return smem[phys].view(np.int8).astype(np.int64)


def a_coords_s8():
    """(warp, lane, reg, byte) -> (row, column in the k32 slice) of the
    int8 register A fragment: a[0] row g bytes 4t.., a[1] row g+8, a[2]
    row g bytes 16+4t.., a[3] row g+8."""
    w, lane, j, b = np.meshgrid(np.arange(4), np.arange(32), np.arange(4),
                                np.arange(4), indexing="ij")
    g, t = lane // 4, lane % 4
    return 16 * w + g + 8 * (j & 1), 4 * t + b + 16 * (j >> 1)


def from_frags(a):
    """A fragments (KT, warp, lane, reg, byte) -> the (64, 32 KT) matrix
    the wgmma chain reads, in its logical k order."""
    row, col = a_coords_s8()
    x = np.zeros((64, 32 * a.shape[0]), np.int64)
    for kt in range(a.shape[0]):
        x[row, 32 * kt + col] = a[kt]
    return x


def wgmma_chain(a, smem, starts, N):
    """sum over k32 steps of A (a[kt]) times the B tile the descriptor at
    starts[kt] reads, as the s32 accumulator fragment (warp, lane, i)."""
    x = from_frags(a)
    d = np.zeros((64, N), np.int64)
    for kt, start in enumerate(starts):
        d += x[:, 32 * kt: 32 * kt + 32] @ descriptor_read_s8(
            smem, start, N).T
    row, col = d_coords(N)
    return d[row, col]


def head_frags(codes):
    """The kernel's `head` writes: a[j][2h] (row g) and a[j][2h + 1] (row
    g + 8) hold the codes of features f, f+1, f+8, f+9, f = 32j + 16h +
    2t, as bytes 0..3 (`__byte_perm(lo[0], lo[1], 0x6420)`)."""
    nf = codes.shape[1]
    a = np.zeros((nf // 32, 4, 32, 4, 4), np.int64)
    w, lane = np.meshgrid(np.arange(4), np.arange(32), indexing="ij")
    g, t = lane // 4, lane % 4
    for j in range(nf // 32):
        for h in range(2):
            f = 32 * j + 16 * h + 2 * t
            for i, df in enumerate((0, 1, 8, 9)):
                a[j][:, :, 2 * h, i] = codes[16 * w + g, f + df]
                a[j][:, :, 2 * h + 1, i] = codes[16 * w + g + 8, f + df]
    return a


def exact_float(a):
    """The kernel's float(a): bits(a + 0x4B400000) - 1.5 * 2^23."""
    bits = (np.asarray(a, np.int64) + 0x4B400000).astype(np.uint32)
    return bits.view(np.float32) - np.float32(12582912.0)


def requant_codes(c, col, st, d, requant):
    """The kernel's `requant` of sums c (int64) in columns col of layer d
    (mode 0): "int" in int32 with an arithmetic shift and min.relu.s32
    against 127; "f32" the FMA on exact_float(c) (modelled in float64 as
    the plain version does), ReLU, clip, + 1.5 * 2^23 and the low byte."""
    if requant == "int":
        m, h, s, b = (st[k][d, 0].numpy().astype(np.int64)[col]
                      for k in ("hmq", "hhq", "hsq", "hbi"))
        wrap = lambda v: ((v + 2**31) % 2**32) - 2**31
        ti = wrap(c * m + h)
        return np.clip(wrap((ti >> s) + b), 0, 127)
    hc, hb = (st[k][d, 0].numpy()[col] for k in ("hcq", "hbq"))
    x = (exact_float(c).astype(np.float64) * hc.astype(np.float64)
         + hb.astype(np.float64)).astype(np.float32)
    y = np.minimum(np.maximum(x, np.float32(0)), np.float32(127))
    return ((y + np.float32(12582912.0)).view(np.uint32) & 0xFF).astype(
        np.int64)


def requant_half(acc, st, d, nh, requant, a, j0):
    """The kernel's `requant_half`: the n128 half nh of a layer's s32
    fragment acc (warp, lane, 64), requantized, tiles (2k, 2k+1) packed
    into a[j0 + k/2][2(k%2)] (row g) and [2(k%2) + 1] (row g + 8)."""
    t = np.arange(32)[None, :] % 4
    q = np.zeros_like(acc)
    for i in range(64):
        col = 128 * nh + 8 * (i // 4) + 2 * t + (i & 1)
        q[:, :, i] = requant_codes(acc[:, :, i], np.broadcast_to(
            col, acc.shape[:2]), st, d, requant)
    for k in range(8):
        q0, q1 = q[:, :, 8 * k: 8 * k + 4], q[:, :, 8 * k + 4: 8 * k + 8]
        a[j0 + k // 2][:, :, 2 * (k & 1)] = np.stack(
            [q0[..., 0], q0[..., 1], q1[..., 0], q1[..., 1]], -1)
        a[j0 + k // 2][:, :, 2 * (k & 1) + 1] = np.stack(
            [q0[..., 2], q0[..., 3], q1[..., 2], q1[..., 3]], -1)
    return a


def layer_starts(nf, depth, d, nh):
    """Descriptor start addresses of layer d's k32 steps for half nh, in
    a mode region (`layer_base` + d nf^2)."""
    base = 64 * nf + d * nf * nf
    return [base + (kt >> 2) * nf * 128 + nh * 128 * 128 + (kt & 3) * 32
            for kt in range(nf // 32)]


def head_starts(nf, r):
    """Descriptor start addresses of rotation r's output-head steps."""
    return [r * 16 * 128 + (kt >> 2) * 64 * 128 + (kt & 3) * 32
            for kt in range(nf // 32)]


def stage_region(st):
    """`stage_mode`'s int8 operands of mode 0 in a mode region: the output
    head at 0, layer d at 64 nf + d nf^2."""
    D, _, nf, _ = st["hwqt"].shape
    smem = np.zeros(64 * nf + D * nf * nf, np.uint8)
    stage_s8(smem, 0, st["w6qt"][0].numpy(), 64 * 128)
    for d in range(D):
        stage_s8(smem, 64 * nf + d * nf * nf, st["hwqt"][d, 0].numpy(),
                 nf * 128)
    return smem


def layers(a, smem, st, requant):
    """Every hidden layer through the model: per n128 half a wgmma chain,
    then the requant into the next A (the first half's codes held until
    the second half's product has read A)."""
    D, _, nf, _ = st["hwqt"].shape
    for d in range(D):
        nxt = np.zeros_like(a)
        for nh in range(nf // 128):
            acc = wgmma_chain(a, smem, layer_starts(nf, D, d, nh), 128)
            requant_half(acc, st, d, nh, requant, nxt, 4 * nh)
        a = nxt
    return a


@functools.cache
def q8_stack(nf, depth, requant, seed=0):
    """A one-mode K11 stack (`quant.kernel_stack` layout) with codes spread
    over [0, 127]: int8 weights, bf16 head weights of a wide range,
    requant constants that clip at both ends ("int" from the f32 ones by
    `quant._fixed_point`)."""
    rng = np.random.default_rng(seed + nf + 10 * depth)
    bf = lambda x: torch.from_numpy(np.asarray(x, np.float32)).to(
        torch.bfloat16)
    hcq = (rng.random((depth, 1, nf)) * 4e-3 + 5e-4).astype(np.float32)
    hbq = rng.normal(20, 30, (depth, 1, nf)).astype(np.float32)
    st = {"w1t": bf(rng.normal(0, 60, (1, nf, 4))),
          "b1": bf(rng.normal(10, 30, (1, nf))),
          "hwqt": torch.from_numpy(rng.integers(-127, 128, (depth, 1, nf, nf))
                                   .astype(np.int8)),
          "w6qt": torch.from_numpy(rng.integers(-127, 128, (1, 64, nf))
                                   .astype(np.int8)),
          "c6": torch.from_numpy((rng.random((1, 64)) * 4e-5 + 1e-6)
                                 .astype(np.float32)),
          "b6": torch.from_numpy(rng.normal(0, 0.5, (1, 64))
                                 .astype(np.float32))}
    if requant == "int":
        m, s, h, b = tq._fixed_point(hcq, hbq, nf)
        st.update(hmq=torch.from_numpy(m), hsq=torch.from_numpy(s),
                  hhq=torch.from_numpy(h), hbi=torch.from_numpy(b))
    else:
        st.update(hcq=torch.from_numpy(hcq), hbq=torch.from_numpy(hbq))
    return st


def _taps(seed, n=64, cols=16):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.random((n, cols), np.float32)).to(
        torch.bfloat16)


def kernel_codes(st, taps):
    """The kernel's head codes of a (64, 4) tap block: the bf16 chain with
    + b1 and ReLU (`_dense_head`, which fma.rn.relu by 1 rounds as
    add.rn does), then the low byte of bf16(min(x, 127) + 128)."""
    x = tuk._dense_head(taps, st["w1t"][0].T, st["b1"][0])
    y = torch.clamp(x, max=127) + 128            # bf16 op: one rounding
    return (y.view(torch.int16).numpy().astype(np.int64) & 0xFF)


# --- staging and fragments ----------------------------------------------------


@pytest.mark.parametrize("nf", cs.W8A8_NFS)
def test_swizzled_int8_staging_reads_back(nf):
    """Each layer's k32 step of each n128 half, and each rotation's head
    step, read at its descriptor address is the stack's slice."""
    st = q8_stack(nf, 2, "int")
    smem = stage_region(st)
    for d in range(2):
        w = st["hwqt"][d, 0].numpy().astype(np.int64)
        for nh in range(nf // 128):
            for kt, start in enumerate(layer_starts(nf, 2, d, nh)):
                np.testing.assert_array_equal(
                    descriptor_read_s8(smem, start, 128),
                    w[128 * nh: 128 * nh + 128, 32 * kt: 32 * kt + 32])
    w6 = st["w6qt"][0].numpy().astype(np.int64)
    for r in range(4):
        for kt, start in enumerate(head_starts(nf, r)):
            np.testing.assert_array_equal(
                descriptor_read_s8(smem, start, 16),
                w6[16 * r: 16 * r + 16, 32 * kt: 32 * kt + 32])


def test_fragments_cover_their_tiles_once():
    row, col = a_coords_s8()
    pairs = set(zip(row.ravel().tolist(), col.ravel().tolist()))
    assert len(pairs) == row.size == 64 * 32
    for N in (8, 16, 128):
        row, col = d_coords(N)
        assert len(set(zip(row.ravel().tolist(), col.ravel().tolist()))) \
            == row.size == 64 * N


@pytest.mark.parametrize("nf", cs.W8A8_NFS)
def test_head_codes_land_in_k32_order(nf):
    """The head's packing puts feature order[k] at the A column k the
    wgmma reads (`quant.k32_feature_order`), so the staged [out][in]
    weights in that order give codes @ W."""
    codes = np.random.default_rng(nf).integers(0, 128, (64, nf))
    x = from_frags(head_frags(codes))
    np.testing.assert_array_equal(x, codes[:, tq.k32_feature_order(nf)])


@pytest.mark.parametrize("requant", ["int", "f32"])
@pytest.mark.parametrize("nf, depth", [(128, 1), (128, 2), (128, 3),
                                       (256, 1), (256, 2), (256, 3)])
def test_layers_through_fragments(nf, depth, requant):
    """Each layer: the A fragments x the staged B through descriptors
    give the exact s32 product, and the requant's packing gives the A
    fragments of the plain requant's codes."""
    st = q8_stack(nf, depth, requant)
    smem = stage_region(st)
    order = tq.k32_feature_order(nf)
    inv = np.argsort(order)
    codes = np.random.default_rng(depth).integers(0, 128, (64, nf))
    a = head_frags(codes)
    for d in range(depth):
        w = st["hwqt"][d, 0].numpy().astype(np.int64)[:, inv]  # features
        want = codes @ w.T                                     # (64, out)
        nxt = np.zeros_like(a)
        row, col = d_coords(128)
        for nh in range(nf // 128):
            acc = wgmma_chain(a, smem, layer_starts(nf, depth, d, nh), 128)
            np.testing.assert_array_equal(acc, want[row, 128 * nh + col])
            requant_half(acc, st, d, nh, requant, nxt, 4 * nh)
        codes = tuk._q8_requant(torch.from_numpy(want.astype(np.float32)),
                                st, d, 0).numpy().astype(np.int64)
        assert 0 < (codes == 0).mean() < 0.9 and (codes == 127).any()
        np.testing.assert_array_equal(from_frags(nxt), codes[:, order])
        a = nxt


@pytest.mark.parametrize("requant", ["int", "f32"])
@pytest.mark.parametrize("nf, depth", [(128, 1), (128, 2), (128, 3),
                                       (256, 2), (256, 3)])
def test_mode_through_fragments_equals_plain(nf, depth, requant):
    """One mode's 4 passes (head codes, layers, rotation r's output head
    (n16), fma(float(a), c6, b6), round(127 tanh) summed) through the
    model equal `stage_ensemble_apply_q_plain` on the tile's taps."""
    st = q8_stack(nf, depth, requant)
    smem = stage_region(st)
    taps = _taps(nf + depth)
    row, col = d_coords(16)
    acc = np.zeros((64, 16), np.float32)
    for r in range(4):
        a = head_frags(kernel_codes(st, taps[:, 4 * r: 4 * r + 4]))
        a = layers(a, smem, st, requant)
        c = np.zeros((64, 16), np.int64)
        c[row, col] = wgmma_chain(a, smem, head_starts(nf, r), 16)
        sl = slice(16 * r, 16 * r + 16)
        o = (exact_float(c).astype(np.float64)
             * st["c6"][0, sl].numpy().astype(np.float64)
             + st["b6"][0, sl].numpy().astype(np.float64)).astype(np.float32)
        acc += torch.round(torch.tanh(torch.from_numpy(o)) * 127.0).numpy()
    with tuk.full_f32_matmul():
        want = tuk.stage_ensemble_apply_q_plain(st, taps, n_modes=1).numpy()
    assert np.abs(want).max() > 100
    np.testing.assert_array_equal(acc, want)


# --- the exact tricks ----------------------------------------------------------


@pytest.mark.parametrize("nf", cs.W8A8_NFS)
def test_exact_float_over_the_whole_range(nf):
    top = 127 * 127 * nf
    assert top < 2**22
    a = np.arange(-top, top + 1, dtype=np.int64)
    np.testing.assert_array_equal(exact_float(a), a.astype(np.float32))


def test_head_codes_over_every_bf16_value():
    """min(x, 127) + 128, rounded once to bf16 (add.rn.bf16x2), has the
    code clip(rint(relu(x)), 0, 127) in its low byte for every bf16 x >= 0
    (fma.rn.relu leaves no negative x), ties to even."""
    x = torch.arange(0, 2**16, dtype=torch.int32).to(torch.int16).view(
        torch.bfloat16)
    x = x[torch.isfinite(x) & (x >= 0)]
    y = torch.clamp(x, max=127) + 128
    got = y.view(torch.int16).numpy().astype(np.int64) & 0xFF
    want = torch.clamp(torch.round(x.float()), 0, 127).numpy()
    np.testing.assert_array_equal(got, want)
    assert ((y.view(torch.int16).numpy().astype(np.int64) & 0xFF00)
            == 0x4300).all()
    half = torch.tensor([0.5, 1.5, 2.5, 126.5], dtype=torch.bfloat16)
    assert ((torch.clamp(half, max=127) + 128).view(torch.int16) & 0xFF
            ).tolist() == [0, 2, 2, 126]


def test_head_weight_layout():
    """`stage_mode`'s w1 words: pair q's 4 taps, features 2q (low half)
    and 2q+1; `b1_slot` puts pairs q and q + 4 (q % 8 < 4) in one 8-byte
    word at 2 * ((q & ~7) / 2 + q % 4), where `head` reads them."""
    assert "w[k] = bits(w1[8 * q + k]) | bits(w1[8 * q + 4 + k]) << 16;" \
        in CODE
    assert "return (q & ~7) + 2 * (q & 3) + ((q >> 2) & 1);" in CODE
    assert "const uint2 b = sB1[(q & ~7) / 2 + t];" in CODE
    slot = lambda q: (q & ~7) + 2 * (q & 3) + ((q >> 2) & 1)
    for nf in cs.W8A8_NFS:
        slots = [slot(q) for q in range(nf // 2)]
        assert sorted(slots) == list(range(nf // 2))
        for q in range(nf // 2):
            if q % 8 < 4:
                assert slot(q) == 2 * ((q & ~7) // 2 + q % 4)
                assert slot(q + 4) == slot(q) + 1


# --- shared memory and launch geometry ----------------------------------------


def region_bytes(nf, depth, int_requant):
    """plain_w8a8.cu's `region_bytes`, transcribed: one mode's output head,
    layers and vectors."""
    return (64 * nf + depth * nf * nf + 10 * nf + 2 * 64 * 4
            + depth * nf * (4 if int_requant else 2) * 4)


def smem_bytes(nf, depth, int_requant, modes, all_modes):
    """plain_w8a8.cu's `smem_bytes`, transcribed: every mode's region
    1024-aligned, or the raw accumulators and one region; + 1 KB."""
    region = region_bytes(nf, depth, int_requant)
    if all_modes:
        return modes * (-(-region // 1024) * 1024) + 1024
    return C["kW6Base"] + region + 1024


def launch_smem(nf, depth, int_requant, modes=3):
    """plain_w8a8.cu's `launch`: all modes at once where they fit."""
    every = smem_bytes(nf, depth, int_requant, modes, True)
    if every <= SMEM_MAX:
        return every, True
    return smem_bytes(nf, depth, int_requant, modes, False), False


def test_smem_formula_is_the_sources():
    for line in ("return vec_base<NF>(depth) + 10 * NF + 2 * kHeadRows * 4 +",
                 "depth * NF * (INTQ ? 4 : 2) * 4;",
                 "return kHeadRows * NF;",
                 "return layer_base<NF>() + depth * NF * NF;",
                 "return (region_bytes<NF, INTQ>(depth) + 1023) / 1024 * 1024;",
                 "return ALL ? (size_t)modes * region_stride<NF, INTQ>(depth) "
                 "+ 1024",
                 ": (size_t)kW6Base + region_bytes<NF, INTQ>(depth) +",
                 "if (all <= (size_t)kSmemMax)"):
        assert line in " ".join(CODE.split()), line
    assert C["kAccBase"] == 0
    assert C["kW6Base"] == C["kBlockSites"] * 16 * 4 == 49_152
    assert C["kSmemMax"] == SMEM_MAX == tuk._SMEM_MAX
    for nf in cs.W8A8_NFS:
        for depth in range(5):
            for intq in (True, False):
                for modes in (1, 3, 6):
                    assert tuk.w8a8_smem_bytes(nf, depth, intq, modes) == \
                        launch_smem(nf, depth, intq, modes)


@pytest.mark.parametrize("requant", [True, False], ids=["int", "f32"])
def test_smem_fits_a_block(requant):
    assert launch_smem(128, 2, True) == (142_336, True)
    assert launch_smem(256, 2, True) == (208_896, False)
    assert launch_smem(128, 3, requant)[1]
    assert not launch_smem(128, 4, requant)[1]
    assert launch_smem(256, 2, requant)[0] <= SMEM_MAX
    assert launch_smem(256, 3, requant)[0] > SMEM_MAX
    assert max(d for d in range(32)
               if launch_smem(128, d, requant)[0] <= SMEM_MAX) == 9
    # each region (output head, layers, vectors) 1024-aligned
    for nf in cs.W8A8_NFS:
        assert (64 * nf) % 1024 == 0 and (nf * nf) % 1024 == 0
        assert (10 * nf + 512) % 16 == 0


def test_wrapper_refuses_what_the_card_cannot_take(monkeypatch):
    """On the card (its device check stubbed here) an nf outside {128,
    256}, or a depth whose mode does not fit shared memory, raises before
    any launch."""
    monkeypatch.setattr(tuk, "_check_device",
                        lambda *ts: torch.device("cuda"))
    taps = torch.zeros((5, 16), dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match=r"nf in \(128, 256\)"):
        tuk.stage_ensemble_apply_q(q8_stack(64, 2, "int"), taps, n_modes=1)
    with pytest.raises(NotImplementedError, match="shared memory"):
        tuk.stage_ensemble_apply_q(q8_stack(256, 4, "f32"), taps, n_modes=1)
    assert not tuk.LAUNCHES["stage_ensemble_apply_q"]


def test_geometry_constants_are_the_sources():
    assert C["kGroups128"] == cs.W8A8_GROUPS[128]
    assert C["kGroups"] == cs.W8A8_GROUPS[256]
    assert "return 128 * (NF == 128 ? kGroups128 : kGroups);" in CODE
    assert C["kTile"] == cs.W8A8_TILE
    assert C["kBlockSites"] == cs.W8A8_BLOCK_SITES
    assert C["kMaxModes"] == tuk._MAX_MODES
    assert cs.W8A8_NFS == tuk._W8A8_NF
    for nf in cs.W8A8_NFS:
        assert f"case {nf}:" in CODE
    assert "wgmma_s8_n128(" in CODE and "ensemble_block<" in CODE
    assert "mma.sync" not in CODE and "mma_s8(" not in CODE
    # the private copies of net_common.cuh's helpers are gone
    for gone in ("ld_b32", "copy_rows", "head_pair", "bf2_relu",
                 "load_taps", "kWarps", "kSites", "kMaxSmem"):
        assert not re.search(rf"\b{gone}\b", CODE), gone


def w8a8_tiles(n, nf):
    """The first site of each 64-site tile warpgroup g of block b runs,
    {(b, g): [sites]}: j = g strided by the warpgroups over the block's
    tiles, stopping at the first tile that starts past n (both block
    loops)."""
    G, tile, T = cs.W8A8_GROUPS[nf], cs.W8A8_TILE, cs.W8A8_BLOCK_SITES
    out = {}
    for b in range(cs.w8a8_grid(n)):
        for g in range(G):
            out[b, g] = []
            for j in range(g, T // tile, G):
                if b * T + j * tile >= n:
                    break
                out[b, g].append(b * T + j * tile)
    return out


@pytest.mark.parametrize("nf", cs.W8A8_NFS)
@pytest.mark.parametrize("n", RAGGED)
def test_tiles_cover_every_site_once(n, nf):
    assert (cs.W8A8_BLOCK_SITES // cs.W8A8_TILE) % cs.W8A8_GROUPS[nf] == 0
    tiles = w8a8_tiles(n, nf)
    starts = np.sort(np.concatenate([np.asarray(v, np.int64)
                                     for v in tiles.values()]))
    np.testing.assert_array_equal(starts, np.arange(0, n, cs.W8A8_TILE))
    assert cs.w8a8_grid(BATCH_CALL) == 4050


@pytest.mark.parametrize("requant", [True, False], ids=["int", "f32"])
@pytest.mark.parametrize("nf", cs.W8A8_NFS)
def test_staged_bytes(nf, requant):
    """chip_smoke's per-call count: per block and mode the int8 layers and
    output head, w1 and b1 as bf16, c6 and b6 and the requant constants
    as 4-byte words; times blocks and modes."""
    per_mode = (2 * nf * nf + 64 * nf + 2 * 5 * nf + 4 * 2 * 64
                + 2 * nf * (4 if requant else 2) * 4)
    if (nf, requant) == (128, True):
        assert per_mode == 46_848
    assert cs.w8a8_staged_bytes(BATCH_CALL, nf=nf, modes=3, depth=2,
                                int_requant=requant) == 4050 * 3 * per_mode


def test_q8_desc_mirrors_q8_params():
    fields = _struct_fields(SRC, "Q8Params")
    assert [f for f, _ in fields] == [f for f, _ in tuk._Q8Desc._fields_]
    for (name, size), (_, ctype) in zip(fields, tuk._Q8Desc._fields_):
        if size is None:
            assert not hasattr(ctype, "_length_"), name
        else:
            assert ctype._length_ == int(size), name
