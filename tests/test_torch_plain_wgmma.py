"""The plain body's wgmma dataflow (csrc/plain_body.cuh), modelled in NumPy
on the CPU, where no CUDA kernel runs; the fragment, swizzle and
descriptor model is tests/test_torch_dense_wgmma.py's.

- Staging: one mode's weights in the source's shared layout (its
  constants read from the source), the 128-row hidden layers in 128-row
  K-blocks, the output head in 64-row ones, read back at the addresses a
  wgmma descriptor gives.
- The heads (both on the CUDA cores): the float32 head's fragments (each
  feature's 4 products summed in tap order in float32, + b1, ReLU, bf16)
  and the bf16 head's (the bf16 chain's features) hold each feature where
  the next layer's A reads it.
- Each hidden layer (depth 2 and 3) through fragments and descriptors,
  packed (+ bias, ReLU, bf16) into the next A fragments, and the output
  head per rotation (n16, n8) equal the plain products; a whole mode (4
  rotations, either head) equals the port's plain `_plain_acc`.  The
  inputs are bf16 values with few significant bits, so every sum is exact
  in any order.
- The launch geometry: the kernel's tile loop over `chip_smoke.plain_grid`
  covers every site once; chip_smoke's constants, shared-memory size and
  staged bytes are the source's, and the shared memory fits a block at
  depth 2 and 3.
- `unit_kernel._PlainDesc` mirrors `PlainParams` field for field.
"""

import functools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke as cs
from mulut_tpu_torch.ops import unit_kernel as tuk
from tests.test_torch_dense_wgmma import (_bf16, _bits, _small, _struct_fields,
                                          a_coords, d_coords, descriptor_read,
                                          from_frags, sw128, to_frags,
                                          wgmma_chain)

CSRC = Path(tuk.__file__).resolve().parent / "csrc"
NF = 128
SMEM_MAX = 232_448               # H100: a block's opt-in shared memory
PLANE = 3_182_784                # a K3 call's sites: 24 planes of 274 x 484
RAGGED = (1, 63, 64, 65, cs.PLAIN_BLOCK_SITES - 1, cs.PLAIN_BLOCK_SITES + 1,
          1_000_003, PLANE)


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
    """The `constexpr int` values of net_common.cuh and plain_body.cuh, in
    source order (C's integer division)."""
    env = {}
    for name in ("net_common.cuh", "plain_body.cuh"):
        text = re.sub(r"//[^\n]*", "", (CSRC / name).read_text())
        for key, expr in re.findall(r"^constexpr int (\w+) = ([^;]+);", text,
                                    re.M):
            env[key] = int(eval(expr.replace("/", "//"), {}, dict(env)))
    return env


C = _constants()


def _stack(seed, depth, modes=1):
    """A plain stack in the kernels' layout, bf16 values with few
    significant bits."""
    rng = np.random.default_rng(seed)
    return {"w1t": _small(rng, (modes, NF, 4), 1 / 8),
            "b1": _small(rng, (modes, NF), 1 / 8),
            "hwt": _small(rng, (depth, modes, NF, NF), 1 / 64),
            "hb": _small(rng, (depth, modes, NF), 1 / 8),
            "w6t": _small(rng, (modes, 64, NF), 1 / 64),
            "b6": _small(rng, (modes, 64), 1 / 8)}


def stage_rows(smem, base, src, K, kblock):
    """plain_body.cuh's staging (`stage_sw128`): (rows, K) bf16 bits into
    swizzled K-blocks kblock bytes apart at base."""
    for r in range(src.shape[0]):
        for c in range(K // 8):
            o = base + sw128(r, c, kblock)
            smem[o: o + 16] = np.ascontiguousarray(
                src[r, 8 * c: 8 * c + 8]).view(np.uint8)


def stage_mode(st, mi, head):
    """`stage_mode`: mode mi's bf16 operands in the source's layout."""
    depth = st["hwt"].shape[0]
    smem = np.zeros(C["kLayerBase"] + depth * C["kLayerBytes"], np.uint8)
    for d in range(depth):
        stage_rows(smem, C["kLayerBase"] + d * C["kLayerBytes"],
                   _bits(st["hwt"][d, mi]), NF, C["kLayerKBlock"])
    stage_rows(smem, C["kW6Base"], _bits(st["w6t"][mi]), NF, C["kKBlock"])
    return smem


def layer_starts(d):
    """Descriptor start addresses of hidden layer d's 8 k16 steps."""
    base = C["kLayerBase"] + d * C["kLayerBytes"]
    return [base + (kt >> 2) * C["kLayerKBlock"] + (kt & 3) * 32
            for kt in range(NF // 16)]


def head_starts(r):
    """Descriptor start addresses of rotation r's output-head steps."""
    return [C["kW6Base"] + r * 16 * 128 + (kt >> 2) * C["kKBlock"]
            + (kt & 3) * 32 for kt in range(NF // 16)]


def f32_head(taps, w1, b1):
    """`f32_head`'s values: per site and feature f the 4 products (exact in
    float32) summed in tap order in float32 (`dot4`), + b1[f], ReLU,
    bf16."""
    t, w = taps.astype(np.float32), w1.astype(np.float32)
    s = t[:, None, 0] * w[None, :, 0]
    for k in range(1, 4):
        s = s + t[:, None, k] * w[None, :, k]
    return _bf16(np.maximum(s + b1.astype(np.float32), np.float32(0)))


def head_frags(x):
    """Both heads' writes (`f32_head`, `bf16x2_head`): features 2q, 2q+1
    (q = 8kt + 4h + t) of row g in a[kt][2h], of row g+8 in a[kt][2h+1]."""
    a = np.zeros((NF // 16, 4, 32, 4, 2))
    w, lane = np.meshgrid(np.arange(4), np.arange(32), indexing="ij")
    g, t = lane // 4, lane % 4
    for kt in range(NF // 16):
        for h in range(2):
            q = 8 * kt + 4 * h + t
            for half in range(2):
                a[kt][:, :, 2 * h, half] = x[16 * w + g, 2 * q + half]
                a[kt][:, :, 2 * h + 1, half] = x[16 * w + g + 8, 2 * q + half]
    return a


def pack_layer(d, hb):
    """`pack_layer` of an m64n128 accumulator fragment d (warp, lane, 64):
    + bias, ReLU, bf16 into A k-tiles 0 .. 7."""
    a = np.zeros((NF // 16, 4, 32, 4, 2))
    t = np.arange(32)[None, :] % 4
    for nt in range(NF // 8):
        cc = nt * 8 + 2 * t
        for i in range(4):
            v = _bf16(np.maximum(d[:, :, 4 * nt + i] + hb[cc + (i & 1)], 0))
            a[nt // 2][:, :, (nt & 1) * 2 + (i >> 1), i & 1] = v
    return a


def _torch(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


@functools.cache
def staged(depth):
    """A one-mode stack of `depth` layers and its staged shared memory."""
    st = _stack(depth, depth)
    return st, stage_mode(st, 0, "mxu")


def test_layout_regions_are_disjoint_and_fit():
    """The source's regions (output head, accumulators, vectors, layers)
    follow each other without overlap; the swizzled ones are 1024-aligned;
    the vectors hold what the kernel reads from them (b1, b6, the hidden
    biases, then the head's weights, 16-byte aligned for the float32
    head's float4 reads, then the plane offsets)."""
    regions = [("kW6Base", 2 * C["kKBlock"]),
               ("kAccBase", cs.PLAIN_BLOCK_SITES * 16 * 4),
               ("kVecBase", C["kVecBytes"])]
    end = 0
    for key, size in regions:
        assert C[key] == end, key
        end += size
    assert C["kLayerBase"] >= end and C["kLayerBase"] % 1024 == 0
    assert C["kW6Base"] % 1024 == 0
    w1 = C["kVecBase"] + 4 * (NF + 64 + C["kMaxDepth"] * NF)
    assert w1 % 16 == 0
    # the float32 head's w1 [nf][4] floats; the bf16 head's pairs fit it
    assert 4 * NF >= 2 * NF + NF // 2
    words = NF + 64 + C["kMaxDepth"] * NF + 4 * NF + C["kMaxModes"] * 16
    assert C["kVecBytes"] == 4 * words


@pytest.mark.parametrize("depth, d", [(2, 0), (2, 1), (3, 0), (3, 1),
                                      (3, 2)])
def test_hidden_layer_through_fragments(depth, d):
    """Hidden layer d: A fragments x the staged B through its 8
    descriptors, then packing, equal bf16(relu(x @ W.T + b))."""
    st, smem = staged(depth)
    x = _small(np.random.default_rng(10 + d), (64, NF), 1 / 4)
    w, b = st["hwt"][d, 0], st["hb"][d, 0]
    acc = wgmma_chain(to_frags(x), smem, layer_starts(d), NF)
    row, col = d_coords(NF)
    np.testing.assert_array_equal(acc, (x @ w.T)[row, col])
    got = from_frags(pack_layer(acc, b))
    np.testing.assert_array_equal(got, _bf16(np.maximum(x @ w.T + b, 0)))


@pytest.mark.parametrize("depth", [2, 3])
def test_float32_head_is_one_k16_step(depth):
    """The float32 head, the one K = 4 step before the layers: `f32_head`
    on the CUDA cores writes bf16(relu(t @ w1t.T + b1)) into the first
    layer's A fragments, where that layer's wgmma chain reads it."""
    st, smem = staged(depth)
    taps = _small(np.random.default_rng(3), (64, 4), 1 / 8)
    w1, b1 = st["w1t"][0], st["b1"][0]
    x = f32_head(taps, w1, b1)
    np.testing.assert_array_equal(x, _bf16(np.maximum(taps @ w1.T + b1, 0)))
    a = head_frags(x)
    np.testing.assert_array_equal(from_frags(a), x)
    acc = wgmma_chain(a, smem, layer_starts(0), NF)
    row, col = d_coords(NF)
    np.testing.assert_array_equal(acc, (x @ st["hwt"][0, 0].T)[row, col])


def test_bf16_head_fragments_are_the_chain():
    """The bf16 head writes each feature where the first layer's A reads
    it: its fragments are `_dense_head`'s matrix (the chain itself is held
    bit-exact in test_torch_dense_wgmma.py)."""
    st = _stack(4, 2)
    taps = _small(np.random.default_rng(4), (64, 4), 1 / 8)
    x = tuk._dense_head(_torch(taps), _torch(st["w1t"][0]).T,
                        _torch(st["b1"][0])).float().numpy()
    np.testing.assert_array_equal(from_frags(head_frags(x)), x)


@pytest.mark.parametrize("r", [0, 1, 2, 3])
@pytest.mark.parametrize("nt", [1, 2], ids=["n8", "n16"])
def test_output_head_through_fragments(r, nt):
    """Rotation r's head (m64n16, or m64n8 for v <= 8): 8 k16 steps from
    the descriptor of row 16r, past the depth-3 layers."""
    st, smem = staged(3)
    x = _small(np.random.default_rng(20 + r), (64, NF), 1 / 4)
    acc = wgmma_chain(to_frags(x), smem, head_starts(r), 8 * nt)
    row, col = d_coords(8 * nt)
    want = x @ st["w6t"][0, 16 * r: 16 * r + 8 * nt].T
    np.testing.assert_array_equal(acc, want[row, col])


@pytest.mark.parametrize("depth", [2, 3])
@pytest.mark.parametrize("head", tuk.HEADS)
def test_mode_through_fragments_equals_plain_acc(depth, head):
    """One mode's 4 passes (head, depth layers, rotation r's output head,
    round(127 tanh) summed) through the model equal `_plain_acc` on the
    (64, 16) tap matrix of the tile."""
    st = _stack(30 + depth, depth)
    smem = stage_mode(st, 0, head)
    taps = _small(np.random.default_rng(40 + depth), (64, 16), 1 / 8)
    row, col = d_coords(16)
    acc = np.zeros((64, 16), np.float32)
    for r in range(4):
        t = taps[:, 4 * r: 4 * r + 4]
        if head == "mxu":
            a = head_frags(f32_head(t, st["w1t"][0], st["b1"][0]))
        else:
            a = head_frags(tuk._dense_head(
                _torch(t), _torch(st["w1t"][0]).T,
                _torch(st["b1"][0])).float().numpy())
        for d in range(depth):
            a = pack_layer(wgmma_chain(a, smem, layer_starts(d), NF),
                           st["hb"][d, 0])
        c = np.zeros((64, 16))
        c[row, col] = wgmma_chain(a, smem, head_starts(r), 16)
        o = torch.tanh(torch.from_numpy(c.astype(np.float32))
                       + torch.from_numpy(
                           st["b6"][0, 16 * r: 16 * r + 16].astype(np.float32)))
        acc += torch.round(o * 127.0).numpy()
    stt = {k: _torch(v) for k, v in st.items()}
    with tuk.full_f32_matmul():
        want = tuk._plain_acc(stt, _torch(taps), 1, head=head).numpy()
    np.testing.assert_array_equal(acc, want)


# --- launch geometry --------------------------------------------------------


def test_geometry_constants_are_the_sources():
    assert C["kGroups"] == cs.PLAIN_GROUPS
    assert C["kTile"] == cs.PLAIN_TILE
    assert C["kBlockSites"] == cs.PLAIN_BLOCK_SITES
    assert (C["kPlainNF"], C["kWideNF"]) == cs.PLAIN_NFS == tuk._PLAIN_NF
    assert C["kMaxDepth"] == cs.PLAIN_MAX_DEPTH == tuk._PLAIN_MAX_DEPTH
    assert C["kMaxModes"] == cs.DENSE_MAX_MODES == tuk._MAX_MODES
    code = re.sub(r"//[^\n]*", "", (CSRC / "plain_body.cuh").read_text())
    assert "return (size_t)kLayerBase + (size_t)depth * kLayerBytes" in code
    assert "wgmma_n128(" in code and "accumulate<KT, 2>" in code
    assert "mma.sync" not in code and "mma_bf16(" not in code
    # one float32 head, on the CUDA cores; both bodies share the block loop
    assert "f32_head<NF>(" in code and "kW1Base" not in code
    dense = (CSRC / "dense_body.cuh").read_text()
    assert "ensemble_block<" in code and "ensemble_block<" in dense
    common = (CSRC / "net_common.cuh").read_text()
    for gone in ("chain_head", "mma_bf16", "ld_b32", "copy_rows",
                 "load_taps(", "load_taps_t", "kWarps", "kSites"):
        assert gone not in common, gone


def plain_tiles(n):
    """The first site of each 64-site tile warpgroup g of block b runs,
    {(b, g): [sites]}, in the kernel's loop order: j = g strided by kGroups
    over the block's kBlockSites / kTile tiles, stopping at the first tile
    that starts past n."""
    G, tile, T = cs.PLAIN_GROUPS, cs.PLAIN_TILE, cs.PLAIN_BLOCK_SITES
    out = {}
    for b in range(cs.plain_grid(n)):
        for g in range(G):
            out[b, g] = []
            for j in range(g, T // tile, G):
                if b * T + j * tile >= n:
                    break
                out[b, g].append(b * T + j * tile)
    return out


@pytest.mark.parametrize("n", RAGGED)
def test_tiles_cover_every_site_once(n):
    tiles = plain_tiles(n)
    starts = np.sort(np.concatenate([np.asarray(v, np.int64)
                                     for v in tiles.values()]))
    np.testing.assert_array_equal(starts, np.arange(0, n, cs.PLAIN_TILE))
    T, G = cs.PLAIN_BLOCK_SITES, cs.PLAIN_GROUPS
    for (b, g), first in tiles.items():
        assert all(b * T <= s < (b + 1) * T and (s // 64) % G == g
                   for s in first)
    assert cs.plain_grid(PLANE) == 4145


@pytest.mark.parametrize("depth", [0, 1, 2, 3, 4])
def test_smem_is_the_sources_and_fits(depth):
    smem = cs.plain_smem_bytes(depth)
    assert smem == C["kLayerBase"] + depth * C["kLayerBytes"] + 1024
    assert smem <= SMEM_MAX
    if depth == 2:
        assert smem == 138_240
    # one more layer than kMaxDepth would not fit a block
    assert cs.plain_smem_bytes(C["kMaxDepth"] + 1) > SMEM_MAX


@pytest.mark.parametrize("head", tuk.HEADS)
@pytest.mark.parametrize("depth", [2, 3])
def test_staged_bytes(depth, head):
    """chip_smoke's per-call count: per block and mode the bf16 operands
    `stage_mode` stages (layers, output head, and for the bf16 head its
    pairs) and the floats (the float32 head's w1 and b1, the biases);
    times blocks and modes."""
    bf16 = 2 * (depth * NF * NF + 64 * NF) + (0 if head == "mxu"
                                              else 2 * (4 * NF + NF))
    floats = 4 * ((5 * NF if head == "mxu" else 0) + depth * NF + 64)
    per_mode = bf16 + floats
    if (depth, head) == (2, "mxu"):
        assert per_mode == 85_760
    assert cs.plain_staged_bytes(PLANE, modes=3, depth=depth,
                                 head=head) == 4145 * 3 * per_mode


# --- the ctypes mirror ------------------------------------------------------


def test_plain_desc_mirrors_plain_params():
    text = (CSRC / "plain_body.cuh").read_text()
    fields = _struct_fields(text, "PlainParams")
    assert [f for f, _ in fields] == [f for f, _ in tuk._PlainDesc._fields_]
    for (name, size), (_, ctype) in zip(fields, tuk._PlainDesc._fields_):
        if size is None:
            assert not hasattr(ctype, "_length_"), name
        else:
            assert ctype._length_ == eval(
                size, {}, {"kMaxModes": C["kMaxModes"]}), name
