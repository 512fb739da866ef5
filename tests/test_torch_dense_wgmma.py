"""The dense body's wgmma dataflow (csrc/dense_body.cuh, csrc/wgmma.cuh),
modelled in NumPy on the CPU, where no CUDA kernel runs.

- Fragment model: a warpgroup's register A fragments of a 64-site tile,
  the weights staged in the K-major 128-byte-swizzled layout and read back
  at the addresses a wgmma descriptor gives, the m64nN float32
  accumulator fragment, and the kernel's packing of it (+ bias, ReLU,
  bf16) into the next layer's A k-tiles.  Each concat layer and the
  output head through the model equal the plain matrix products exactly:
  the inputs are bf16 values with few significant bits, so every sum is
  exact in any order.
- The rotation-paired staging (K9) puts `pair_stage_params`' diagonal
  blocks at the same bytes as the unpaired stack's staging (K4): equal.
- The launch geometry: the kernel's tile loops, transcribed here
  (`dense_tiles`) over `chip_smoke.dense_grid`, cover every site exactly
  once, and chip_smoke's geometry constants are the source's.
- `unit_kernel._DenseDesc` mirrors `DenseParams` field for field.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke as cs
from mulut_tpu_torch.ops import unit_kernel as tuk

CSRC = Path(tuk.__file__).resolve().parent / "csrc"
NF = 64
KBLOCK = 64 * 128          # bytes of one swizzled 64-row x 64-column K-block
HEAD_BASE = KBLOCK * 10    # layer_base(5)
RAGGED = (1, 63, 65, cs.DENSE_BLOCK_SITES - 1, cs.DENSE_BLOCK_SITES + 1,
          1_000_003)
BENCH = (3_110_400, 12_441_600)   # an ensemble call's sites, K10's rows


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's CPU ops on one thread while this module runs: its many
    small ops under the suite's worker processes otherwise spend their
    time in OpenMP barriers of oversubscribed cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf16(x):
    return torch.from_numpy(np.asarray(x, np.float32)).to(
        torch.bfloat16).float().numpy().astype(np.float64)


def _bits(x):
    """bf16 bit patterns of bf16-valued x."""
    t = torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)
    return t.view(torch.int16).numpy().view(np.uint16)


def _from_bits(b):
    return torch.from_numpy(b.view(np.int16).copy()).view(
        torch.bfloat16).float().numpy().astype(np.float64)


def _small(rng, shape, scale):
    """bf16 values k * scale, |k| <= 8: 4 significant bits."""
    return rng.integers(-8, 9, shape) * scale


# --- the model -------------------------------------------------------------


def sw128(r, c, kblock=KBLOCK):
    """wgmma.cuh's sw128: byte offset of 16-byte chunk c of row r."""
    return (c >> 3) * kblock + r * 128 + (((c & 7) ^ (r & 7)) << 4)


def stage(smem, base, src, rows, K, ld, *, paired=False, odd=0):
    """dense_body.cuh's `stage`: rows x K bf16 from the flat bit array src
    (row stride ld; paired: the diagonal blocks) into swizzled K-blocks of
    the byte array smem at base."""
    per_block = NF // 8
    for r in range(rows):
        for c in range(K // 8):
            col = ((c // per_block) * 2 * NF + 8 * (c % per_block)
                   + ((r >> 4) & 1) * odd) if paired else 8 * c
            chunk = src[r * ld + col: r * ld + col + 8]
            o = base + sw128(r, c)
            smem[o: o + 16] = chunk.view(np.uint8)


def descriptor_read(smem, start, N):
    """The 16 x N B tile (as [n][k]) a K-major 128B-swizzled descriptor at
    byte address `start` (relative to a 1024-aligned base) reads: row n,
    column k at start + (n // 8) * 1024 + (n % 8) * 128 + 2k, the address
    bits [4, 7) XORed with bits [7, 10)."""
    n, k = np.meshgrid(np.arange(N), np.arange(16), indexing="ij")
    addr = start + (n // 8) * 1024 + (n % 8) * 128 + 2 * k
    phys = addr ^ (((addr >> 7) & 7) << 4)
    lo, hi = smem[phys], smem[phys + 1]
    return _from_bits((lo.astype(np.uint16) | (hi.astype(np.uint16) << 8)))


def a_coords():
    """(warp, lane, reg, half) -> (row, column in the 16-wide k-tile) of
    the register A fragment (mma.sync's m16n8k16 layout per warp)."""
    w, lane, j, h = np.meshgrid(np.arange(4), np.arange(32), np.arange(4),
                                np.arange(2), indexing="ij")
    g, t = lane // 4, lane % 4
    return 16 * w + g + 8 * (j & 1), 2 * t + 8 * (j >> 1) + h


def d_coords(N):
    """(warp, lane, i) -> (row, column) of the m64nN float32 accumulator
    fragment."""
    w, lane, i = np.meshgrid(np.arange(4), np.arange(32), np.arange(N // 2),
                             indexing="ij")
    g, t = lane // 4, lane % 4
    return 16 * w + g + 8 * ((i % 4) >> 1), 8 * (i // 4) + 2 * t + (i & 1)


def to_frags(x):
    """(64, 16 KT) values -> A fragments (KT, warp, lane, reg, half)."""
    row, col = a_coords()
    return np.stack([x[row, 16 * kt + col] for kt in range(x.shape[1] // 16)])


def from_frags(a):
    row, col = a_coords()
    x = np.full((64, 16 * a.shape[0]), np.nan)
    for kt in range(a.shape[0]):
        x[row, 16 * kt + col] = a[kt]
    return x


def wgmma_chain(a, smem, starts, N):
    """sum over k-tiles kt of A (from the fragments a[kt]) times the B tile
    the descriptor at starts[kt] reads, as the accumulator fragment
    (warp, lane, i)."""
    x = from_frags(a)
    d = np.zeros((64, N))
    for kt, start in enumerate(starts):
        d += x[:, 16 * kt: 16 * kt + 16] @ descriptor_read(smem, start, N).T
    row, col = d_coords(N)
    return d[row, col]


def pack_next(a, d, hb, l):
    """dense_body.cuh's packing of layer l+1's accumulator d (warp, lane,
    32) into a[l*NF/16 ..]: + bias, ReLU, bf16."""
    t = np.arange(32)[None, :] % 4
    for nt in range(NF // 8):
        cc = nt * 8 + 2 * t
        kt = l * NF // 16 + nt // 2
        for i in range(4):
            v = _bf16(np.maximum(d[:, :, 4 * nt + i] + hb[cc + (i & 1)], 0))
            a[kt][:, :, (nt & 1) * 2 + (i >> 1), i & 1] = v
    return a


def layer_starts(l):
    return [tuk_layer_base(l) + (kt >> 2) * KBLOCK + (kt & 3) * 32
            for kt in range(l * NF // 16)]


def tuk_layer_base(l):
    return KBLOCK * (l - 1) * l // 2


@pytest.fixture(scope="module")
def stack():
    """One mode of a dense stack in the kernels' layout, bf16 values with
    few significant bits, and its staged shared memory (K4's layout)."""
    rng = np.random.default_rng(0)
    st = {"w6t": _small(rng, (1, 64, 5 * NF), 1 / 64),
          "b6": _small(rng, (1, 64), 1 / 8),
          "w1t": _small(rng, (1, NF, 4), 1 / 8),
          "b1": _small(rng, (1, NF), 1 / 8)}
    for k in (2, 3, 4, 5):
        st[f"w{k}t"] = _small(rng, (1, NF, (k - 1) * NF), 1 / 64)
        st[f"b{k}"] = _small(rng, (1, NF), 1 / 8)
    smem = np.zeros(HEAD_BASE + 5 * KBLOCK, np.uint8)
    for l in (1, 2, 3, 4):
        stage(smem, tuk_layer_base(l), _bits(st[f"w{l + 1}t"][0]).ravel(),
              NF, l * NF, l * NF)
    stage(smem, HEAD_BASE, _bits(st["w6t"][0]).ravel(), 64, 5 * NF, 5 * NF)
    return st, smem


def test_swizzle_is_a_permutation_of_each_atom():
    r, c = np.meshgrid(np.arange(64), np.arange(8), indexing="ij")
    offs = sw128(r, c).ravel()
    assert sorted(offs) == list(range(0, KBLOCK, 16))
    # a k16 step's 8 rows x 32 bytes fall in 8 distinct 16-byte bank groups
    # of each 128-byte row pair: the 8 rows of an atom hit all 8 chunks
    for s in range(4):
        chunks = {(sw128(rr, 2 * s) % 128) // 16 for rr in range(8)}
        assert chunks == set(range(8))


@pytest.mark.parametrize("l", [1, 2, 3, 4])
def test_concat_layer_through_fragments(stack, l):
    """Layer l+1: A fragments of the concat so far x the staged B through
    its descriptors, then packing, equal bf16(relu(x @ W.T + b))."""
    st, smem = stack
    rng = np.random.default_rng(l)
    x = _small(rng, (64, l * NF), 1 / 4)
    a = np.zeros((5 * NF // 16, 4, 32, 4, 2))
    a[: l * NF // 16] = to_frags(x)
    w, b = st[f"w{l + 1}t"][0], st[f"b{l + 1}"][0]
    d = wgmma_chain(a[: l * NF // 16], smem, layer_starts(l), NF)
    row, col = d_coords(NF)
    np.testing.assert_array_equal(d, (x @ w.T)[row, col])
    a = pack_next(a, d, b, l)
    got = from_frags(a[l * NF // 16: (l + 1) * NF // 16])
    np.testing.assert_array_equal(got, _bf16(np.maximum(x @ w.T + b, 0)))
    # the packing leaves the earlier slots alone
    np.testing.assert_array_equal(from_frags(a[: l * NF // 16]), x)


@pytest.mark.parametrize("r", [0, 1, 2, 3])
@pytest.mark.parametrize("nt", [1, 2])
def test_output_head_through_fragments(stack, r, nt):
    """Rotation r's head (m64n16, or m64n8 for v <= 8): the descriptor of
    row 16r, over the whole (64, 5nf) concat."""
    st, smem = stack
    x = _small(np.random.default_rng(10 + r), (64, 5 * NF), 1 / 4)
    starts = [HEAD_BASE + r * 16 * 128 + (kt >> 2) * KBLOCK + (kt & 3) * 32
              for kt in range(5 * NF // 16)]
    d = wgmma_chain(to_frags(x), smem, starts, 8 * nt)
    want = x @ st["w6t"][0, 16 * r: 16 * r + 8 * nt].T
    row, col = d_coords(8 * nt)
    np.testing.assert_array_equal(d, want[row, col])


def test_pass_through_fragments_equals_plain_dense_pass(stack):
    """One whole pass (head, 4 layers, rotation 2's head) through the
    model equals the port's plain `_dense_pass` before its tanh."""
    st, smem = stack
    taps = _small(np.random.default_rng(5), (64, 4), 1 / 8)
    stt = {k: torch.from_numpy(v.astype(np.float32)).to(torch.bfloat16)
           for k, v in st.items()}
    tt = torch.from_numpy(taps.astype(np.float32)).to(torch.bfloat16)
    head = tuk._dense_head(tt, stt["w1t"][0].T, stt["b1"][0]).float().numpy()
    a = np.zeros((5 * NF // 16, 4, 32, 4, 2))
    a[: NF // 16] = to_frags(head.astype(np.float64))
    for l in (1, 2, 3, 4):
        d = wgmma_chain(a[: l * NF // 16], smem, layer_starts(l), NF)
        a = pack_next(a, d, st[f"b{l + 1}"][0], l)
    starts = [HEAD_BASE + 2 * 16 * 128 + (kt >> 2) * KBLOCK + (kt & 3) * 32
              for kt in range(5 * NF // 16)]
    d = wgmma_chain(a, smem, starts, 16)
    with tuk.full_f32_matmul():
        want = tuk._dense_pass(stt, tt, 0, slice(32, 48)).numpy()
    row, col = d_coords(16)
    got = d.astype(np.float32) + st["b6"][0, 32:48][col].astype(np.float32)
    np.testing.assert_array_equal(got, want[row, col])


def test_paired_staging_equals_unpaired(stack):
    """K9 stages `pair_stage_params`' diagonal blocks (odd rotations'
    output-head rows from the second half of each block) to the bytes
    K4 stages from the unpaired stack."""
    st, smem = stack
    stt = {k: torch.from_numpy(v.astype(np.float32)).to(torch.bfloat16)
           for k, v in st.items()}
    paired = tuk.pair_stage_params(stt)
    got = np.zeros_like(smem)
    for l in (1, 2, 3, 4):
        w = paired[f"w{l + 1}t"][0].view(torch.int16).numpy().view(np.uint16)
        stage(got, tuk_layer_base(l), w.ravel(), NF, l * NF, 2 * l * NF,
              paired=True)
    w6 = paired["w6t"][0].view(torch.int16).numpy().view(np.uint16)
    stage(got, HEAD_BASE, w6.ravel(), 64, 5 * NF, 10 * NF, paired=True,
          odd=NF)
    np.testing.assert_array_equal(got, smem)


def _rn_bf16(x):
    """Exact float64 values rounded to bf16's 8 significant bits, to
    nearest even (normal range)."""
    _, e = np.frexp(x)
    scale = np.ldexp(1.0, e - 8)
    return np.round(x / scale) * scale


@pytest.mark.parametrize("spread", [1, 12, 40])
def test_bf16x2_head_is_the_chain(spread):
    """The kernel's head computes each bf16 op on the exact result, rounded
    once to bf16 (mul.rn / add.rn / max.bf16x2); the port's head rounds
    the float32 result.  Equal on bf16 taps, weights and biases whose
    exponents spread over 2 * `spread` binades (with zeros and signs)."""
    rng = np.random.default_rng(spread)

    def bf(shape):
        m = rng.integers(-255, 256, shape) / 128.0
        return _bf16(m * 2.0 ** rng.integers(-spread, spread + 1, shape))

    t, w1, b1 = bf((4096, 4)), bf((4, 16)), bf((16,))
    s = _rn_bf16(t[:, :1] * w1[0])
    for k in range(1, 4):
        s = _rn_bf16(s + _rn_bf16(t[:, k: k + 1] * w1[k]))
    got = np.maximum(_rn_bf16(s + b1), 0)
    f = lambda a: torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    want = tuk._dense_head(f(t), f(w1), f(b1)).float().numpy()
    np.testing.assert_array_equal(got, want.astype(np.float64))


# --- launch geometry --------------------------------------------------------


def _constexpr(text, name):
    m = re.search(rf"constexpr int {name} = ([^;]+);", text)
    assert m, name
    return int(eval(m.group(1), {}, {"kTile": cs.DENSE_TILE}))


def test_geometry_constants_are_the_sources():
    text = (CSRC / "dense_body.cuh").read_text()
    assert _constexpr(text, "kGroups") == cs.DENSE_GROUPS
    assert _constexpr(text, "kTile") == cs.DENSE_TILE
    assert _constexpr(text, "kBlockSites") == cs.DENSE_BLOCK_SITES
    common = (CSRC / "net_common.cuh").read_text()
    assert _constexpr(common, "kMaxModes") == cs.DENSE_MAX_MODES
    assert cs.DENSE_NF == tuk._DENSE_NF and cs.DENSE_LANES == tuk._LANES
    code = re.sub(r"//[^\n]*", "", text)
    assert "wgmma_n64(" in code
    assert "mma.sync" not in code and "mma_bf16(" not in code


def dense_tiles(n, *, unit, sms):
    """The first site of each 64-site tile that warpgroup g of block b
    runs, {(b, g): [sites]}, in the kernel's loop order: `unit_tiles`
    (K10) strides tile j = b * kGroups + g by gridDim * kGroups up to
    ceil(n / kTile); the ensembles' mode loop strides j = g by kGroups
    over the block's kBlockSites / kTile tiles and stops at the first
    tile that starts past n."""
    grid = cs.dense_grid(n, unit=unit, sms=sms)
    G, tile, T = cs.DENSE_GROUPS, cs.DENSE_TILE, cs.DENSE_BLOCK_SITES
    out = {}
    for b in range(grid):
        for g in range(G):
            if unit:
                js = range(b * G + g, -(-n // tile), grid * G)
                out[b, g] = [j * tile for j in js]
            else:
                out[b, g] = []
                for j in range(g, T // tile, G):
                    if b * T + j * tile >= n:
                        break
                    out[b, g].append(b * T + j * tile)
    return out


@pytest.mark.parametrize("unit", [False, True], ids=["ensemble", "unit"])
@pytest.mark.parametrize("n", RAGGED + BENCH)
def test_tiles_cover_every_site_once(n, unit):
    sms = 132
    tiles = dense_tiles(n, unit=unit, sms=sms)
    grid = cs.dense_grid(n, unit=unit, sms=sms)
    assert {b for b, _ in tiles} <= set(range(grid))
    starts = np.sort(np.concatenate([np.asarray(v, np.int64)
                                     for v in tiles.values()]))
    # 64-site tiles from every start: each site of [0, n) exactly once
    np.testing.assert_array_equal(starts, np.arange(0, n, cs.DENSE_TILE))
    G, T = cs.DENSE_GROUPS, cs.DENSE_BLOCK_SITES
    for (b, g), first in tiles.items():
        if unit:
            assert grid <= sms
            assert all((s // 64 - b * G - g) % (grid * G) == 0 for s in first)
        else:
            assert all(b * T <= s < (b + 1) * T and (s // 64) % G == g
                       for s in first)


def test_smem_fits_one_block_per_sm():
    assert cs.dense_smem_bytes(unit=False) == 175_360
    assert cs.dense_smem_bytes(unit=True) == 126_208
    assert cs.dense_smem_bytes(unit=False) <= 232_448   # H100 opt-in max


def test_staged_bytes():
    per_mode = 2 * (10 * NF * NF + 64 * 5 * NF + 5 * NF) + 4 * (4 * NF + 64)
    assert per_mode == 124_800
    n = BENCH[0]
    assert cs.dense_staged_bytes(n, modes=3, v=16, unit=False,
                                 sms=132) == 4050 * 3 * per_mode
    assert cs.dense_staged_bytes(BENCH[1], modes=1, v=8, unit=True,
                                 sms=132) == 132 * 88_736
    assert cs.dense_staged_bytes(1, modes=1, v=16, unit=True,
                                 sms=132) == 93_888


# --- the ctypes mirror ------------------------------------------------------


def _struct_fields(text, name):
    body = re.search(rf"struct {name} \{{(.*?)\n\}};", text, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    fields = []
    for decl in body.split(";"):
        decl = " ".join(decl.split())
        if not decl:
            continue
        names = decl.split(" ", 1)[1] if not decl.startswith("const ") \
            else decl.split("* ", 1)[1]
        if decl.startswith(("long long ", "void* ")):
            names = decl.split(" ", 2)[-1] if decl.startswith("long") \
                else decl.split(" ", 1)[1]
        for nm in names.split(","):
            nm = nm.strip()
            m = re.match(r"(\w+)(?:\[(.+)\])?$", nm)
            fields.append((m.group(1), m.group(2)))
    return fields


def test_dense_desc_mirrors_dense_params():
    text = (CSRC / "dense_body.cuh").read_text()
    common = (CSRC / "net_common.cuh").read_text()
    kmax = _constexpr(common, "kMaxModes")
    fields = _struct_fields(text, "DenseParams")
    assert [f for f, _ in fields] == [f for f, _ in tuk._DenseDesc._fields_]
    for (name, size), (_, ctype) in zip(fields, tuk._DenseDesc._fields_):
        if size is None:
            assert not hasattr(ctype, "_length_"), name
        else:
            assert ctype._length_ == eval(size, {}, {"kMaxModes": kmax}), name


@pytest.mark.parametrize("n", [1, 2, 3])
def test_pack_rows_any_n(n):
    """The "final_pack" plain epilogue at any site count (K5 and K7 at a
    ragged n): byte sx of word sy is lane 4*sy + sx."""
    vi = torch.from_numpy(np.random.default_rng(n).integers(
        0, 256, (16, n)).astype(np.float32))
    words = tuk._pack_rows(vi).numpy().astype("<i4")
    got = words.view(np.uint8).reshape(4, n, 4).transpose(0, 2, 1)
    np.testing.assert_array_equal(got.reshape(16, n), vi.numpy())
