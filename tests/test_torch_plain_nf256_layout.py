"""The plain body's nf=256 path (csrc/plain_body.cuh `plain_wide_kernel`),
modelled in NumPy on the CPU, where no CUDA kernel runs; the fragment,
swizzle and descriptor model is tests/test_torch_dense_wgmma.py's.

- The ring's fills: `unit_kernel.ring_layers` lays the layers out as the
  ring streams them (mode, layer, quarter of the outputs, half of the
  inputs; 2 K-blocks of 64 rows of 128 swizzled bytes each), so a
  quarter's two fills, in whichever slots they land, read through its two
  chains' descriptors and summed give that quarter of x @ W.T; the four
  quarters packed (+ bias, ReLU, bf16) are the next layer's 16 A k-tiles;
  a whole mode (4 rotations, either head, depth 2) through the model
  equals the port's plain `_plain_acc`.
- The ring's protocol, walked by 12 warps in random interleavings: every
  fill is issued once, into its slot, only after every warp released the
  fill 5 places before it; no walk deadlocks; the kernel's source of the
  refill (`next`) is the fill 5 places on, and none past the sequence.
- The launch geometry: the source's constants, shared memory (the same at
  depth 1-4, within a block's 232,448 B), chip_smoke's copies and staged
  bytes; the wrapper refuses other widths, depths and mode counts.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke as cs
from mulut_tpu_torch.ops import unit_kernel as tuk
from tests.test_torch_dense_wgmma import (_bf16, _bits, _small, d_coords,
                                          from_frags, to_frags, wgmma_chain)
from tests.test_torch_plain_wgmma import _constants, stage_rows

CSRC = Path(tuk.__file__).resolve().parent / "csrc"
NF = 256
SMEM_MAX = 232_448               # H100: a block's opt-in shared memory
C = _constants()
SLOTS, SLOT = C["kWideSlots"], C["kWideSlotBytes"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's CPU ops on one thread while this module runs: its many
    small ops under the suite's worker processes otherwise spend their
    time in OpenMP barriers of oversubscribed cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stack(seed, depth, modes=1):
    """A plain nf=256 stack in the kernels' layout, bf16 values with few
    significant bits (every sum exact in any order)."""
    rng = np.random.default_rng(seed)
    return {"w1t": _small(rng, (modes, NF, 4), 1 / 8),
            "b1": _small(rng, (modes, NF), 1 / 8),
            "hwt": _small(rng, (depth, modes, NF, NF), 1 / 128),
            "hb": _small(rng, (depth, modes, NF), 1 / 8),
            "w6t": _small(rng, (modes, 64, NF), 1 / 128),
            "b6": _small(rng, (modes, 64), 1 / 8)}


def _torch(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


def ring_bytes(st):
    """`ring_layers` of the stack's layers as bytes, (M, D, 4, 2, SLOT)."""
    hws = tuk.ring_layers(_torch(st["hwt"]))
    M, D = hws.shape[:2]
    b = hws.view(torch.int16).numpy().view(np.uint8)
    return b.reshape(M, D, 4, 2, SLOT)


def test_ring_fill_is_the_staged_quarter_half():
    """Fill (m, d, q, h) is byte for byte what stage_sw128 would stage of
    rows 64q.. and columns 128h.. of hwt[d, m] as 2 K-blocks of 64 rows."""
    st = _stack(1, 2, modes=2)
    rb = ring_bytes(st)
    assert tuple(tuk.ring_layers(_torch(st["hwt"])).shape) == (
        2, 2, 4, 2, 2, 64, 8, 8)
    for m in range(2):
        for d in range(2):
            for q in range(4):
                for h in range(2):
                    want = np.zeros(SLOT, np.uint8)
                    stage_rows(want, 0, _bits(st["hwt"][d, m][
                        64 * q: 64 * q + 64, 128 * h: 128 * h + 128]),
                        128, C["kKBlock"])
                    np.testing.assert_array_equal(rb[m, d, q, h], want)


def _half_starts(slot):
    """The 8 descriptor starts of one chain over the fill in ring slot
    `slot` (relative to the ring's base): 2 K-blocks of 4 k16 steps."""
    return [slot * SLOT + (k >> 2) * C["kKBlock"] + (k & 3) * 32
            for k in range(8)]


def pack_quarter(acc, hb):
    """`pack_layer<8>` of an m64n64 sum fragment (warp, lane, 32): + bias,
    ReLU, bf16 into 4 A k-tiles (features 2t, 2t+1 of tile nt at
    a[nt // 2][(nt & 1) * 2 + (i >> 1)])."""
    a = np.zeros((4, 4, 32, 4, 2))
    t = np.arange(32)[None, :] % 4
    for nt in range(8):
        cc = nt * 8 + 2 * t
        for i in range(4):
            v = _bf16(np.maximum(acc[:, :, 4 * nt + i] + hb[cc + (i & 1)], 0))
            a[nt // 2][:, :, (nt & 1) * 2 + (i >> 1), i & 1] = v
    return a


def layer_through_ring(a, rb_layer, hb, first_fill):
    """One hidden layer as the kernel runs it: per quarter q its fills
    first_fill + 2q and + 1 in their slots, two chains over a's k-tiles
    0-7 and 8-15, their sum packed into k-tiles 4q .. 4q+3; returns the
    next A and the quarters' sums."""
    out, sums = [], []
    for q in range(4):
        ring = np.zeros(SLOTS * SLOT, np.uint8)
        parts = []
        for h in range(2):
            s = (first_fill + 2 * q + h) % SLOTS
            ring[s * SLOT: (s + 1) * SLOT] = rb_layer[q, h]
            parts.append(wgmma_chain(a[8 * h: 8 * h + 8], ring,
                                     _half_starts(s), 64))
        sums.append(parts[0] + parts[1])
        out.append(pack_quarter(sums[-1], hb[64 * q: 64 * q + 64]))
    return np.concatenate(out), sums


@pytest.mark.parametrize("first_fill", [0, 3, 7])
def test_layer_through_ring_fragments(first_fill):
    """One hidden layer through the ring, its fills in the slots a fill
    sequence starting at `first_fill` puts them in: each quarter's sum is
    that quarter of x @ W.T, and the packed quarters are
    bf16(relu(x @ W.T + b))."""
    st = _stack(2, 1)
    x = _small(np.random.default_rng(3), (64, NF), 1 / 4)
    w, b = st["hwt"][0, 0], st["hb"][0, 0]
    nxt, sums = layer_through_ring(to_frags(x), ring_bytes(st)[0, 0], b,
                                   first_fill)
    row, col = d_coords(64)
    for q, acc in enumerate(sums):
        np.testing.assert_array_equal(
            acc, (x @ w[64 * q: 64 * q + 64].T)[row, col])
    np.testing.assert_array_equal(from_frags(nxt),
                                  _bf16(np.maximum(x @ w.T + b, 0)))


@pytest.mark.parametrize("head", tuk.HEADS)
def test_mode_through_ring_equals_plain_acc(head):
    """One mode's 4 passes at nf=256, depth 2 (the heads write the first
    layer's A k-tiles, held at nf=128 in test_torch_plain_wgmma.py; the
    layers through the ring's fills; the output head from w6t staged as 4
    K-blocks of 64 rows) equal `_plain_acc` on the (64, 16) taps."""
    st = _stack(4, 2)
    rb = ring_bytes(st)[0]
    w6 = np.zeros(4 * C["kKBlock"], np.uint8)
    stage_rows(w6, 0, _bits(st["w6t"][0]), NF, C["kKBlock"])
    taps = _small(np.random.default_rng(5), (64, 16), 1 / 8)
    stt = {k: _torch(v) for k, v in st.items()}
    row, col = d_coords(16)
    acc = np.zeros((64, 16), np.float32)
    for r in range(4):
        with tuk.full_f32_matmul():
            if head == "mxu":
                x = _bf16(np.maximum(taps[:, 4 * r: 4 * r + 4]
                                     @ st["w1t"][0].T + st["b1"][0], 0))
            else:
                x = tuk._dense_head(_torch(taps[:, 4 * r: 4 * r + 4]),
                                    stt["w1t"][0].T,
                                    stt["b1"][0]).float().numpy()
        a = to_frags(x)
        for d in range(2):
            a, _ = layer_through_ring(a, rb[d], st["hb"][d, 0], 8 * d)
        starts = [r * 16 * 128 + (kt >> 2) * C["kKBlock"] + (kt & 3) * 32
                  for kt in range(NF // 16)]
        c = np.zeros((64, 16))
        c[row, col] = wgmma_chain(a, w6, starts, 16)
        o = torch.tanh(torch.from_numpy(c.astype(np.float32))
                       + torch.from_numpy(st["b6"][0, 16 * r: 16 * r + 16]
                                          .astype(np.float32)))
        acc += torch.round(o * 127.0).numpy()
    with tuk.full_f32_matmul():
        want = tuk._plain_acc(stt, _torch(taps), 1, head=head).numpy()
    np.testing.assert_array_equal(acc, want)


# --- the ring's protocol ----------------------------------------------------


def fill_sequence(modes, depth, rounds):
    """Per fill of a block, in the order every warp walks them: (mode,
    last pass of the mode, pass position u)."""
    pp = 8 * depth
    return [(mi, r == 3 and rnd == rounds - 1, u)
            for mi in range(modes) for rnd in range(rounds)
            for r in range(4) for u in range(pp)]


def kernel_next(mi, last, u, modes, depth):
    """`plain_wide_kernel`'s `next(u)`: the index in ring_layers' order of
    the fill kWideSlots places on, or None past the sequence."""
    pp = 8 * depth
    uf = u + SLOTS
    f = mi * pp + uf - (pp if uf >= pp and not last else 0)
    return f if f < modes * pp else None


@pytest.mark.parametrize("modes,depth,rounds", [(3, 2, 4), (1, 1, 1),
                                                (6, 4, 2), (2, 3, 3)])
def test_next_source_is_five_fills_on(modes, depth, rounds):
    seq = fill_sequence(modes, depth, rounds)
    pp = 8 * depth
    for i, (mi, last, u) in enumerate(seq):
        got = kernel_next(mi, last, u, modes, depth)
        if i + SLOTS < len(seq):
            m2, _, u2 = seq[i + SLOTS]
            assert got == m2 * pp + u2, i
        else:
            assert got is None, i


def _warp_program(n_fills):
    """A warp's walk (quarter_chain): per quarter of a layer, wait for its
    2 fills, then release them in order; ("wait", i) and ("release", i)."""
    ops = []
    for c0 in range(0, n_fills, 2):
        ops += [("wait", c0), ("wait", c0 + 1), ("release", c0),
                ("release", c0 + 1)]
    return ops


@pytest.mark.parametrize("seed", range(6))
def test_ring_protocol_in_random_interleavings(seed):
    """12 warps (3 warpgroups x 4) walk 3 modes x 4 rounds x 4 passes of a
    depth-2 sequence in a random interleaving; a wait blocks until its
    fill landed.  The initial fills 0-4 are issued at the start, each
    later one by the release that completes its predecessor's count (the
    fill 5 places before it, in the same slot)."""
    rng = np.random.default_rng(seed)
    warps = 4 * cs.PLAIN_GROUPS
    n = 3 * 4 * 4 * 16
    progs = [_warp_program(n) for _ in range(warps)]
    pos = [0] * warps
    landed = set(range(SLOTS))
    issued = list(range(SLOTS))
    count = [0] * SLOTS
    held = [set() for _ in range(warps)]
    in_slot = {s: s for s in range(SLOTS)}
    while any(p < len(prog) for p, prog in zip(pos, progs)):
        ready = [w for w in range(warps) if pos[w] < len(progs[w]) and (
            progs[w][pos[w]][0] == "release"
            or progs[w][pos[w]][1] in landed)]
        assert ready, "deadlock"
        w = int(rng.choice(ready))
        op, i = progs[w][pos[w]]
        pos[w] += 1
        if op == "wait":
            assert in_slot[i % SLOTS] == i
            held[w].add(i)
            assert len(held[w]) <= 2
            continue
        held[w].remove(i)
        count[i % SLOTS] += 1
        if count[i % SLOTS] == warps:
            count[i % SLOTS] = 0
            assert not any(i in h for h in held)
            if i + SLOTS < n:
                in_slot[i % SLOTS] = i + SLOTS
                landed.add(i + SLOTS)
                issued.append(i + SLOTS)
    assert sorted(issued) == list(range(n)) and len(issued) == n


# --- launch geometry --------------------------------------------------------


def test_wide_layout_regions_are_disjoint_and_fit():
    regions = [("kWideW6Base", 4 * C["kKBlock"]),
               ("kWideAccBase", cs.PLAIN_BLOCK_SITES * 16 * 2),
               ("kStashBase", C["kStashBytes"]),
               ("kWideVecBase", C["kWideVecBytes"]),
               ("kBarBase", 12 * SLOTS)]
    end = 0
    for key, size in regions:
        assert C[key] == end, key
        end += size
    assert C["kBarBase"] % 8 == 0
    assert C["kRingBase"] >= end and C["kRingBase"] % 1024 == 0
    # three quarters of a layer's packed outputs per thread, 12 k-tiles
    assert C["kStashBytes"] == cs.PLAIN_GROUPS * 128 * 12 * 16
    assert SLOT == 2 * C["kKBlock"] == 64 * 128 * 2 and C["kWideNF"] == NF
    assert C["kWideSmem"] == C["kRingBase"] + SLOTS * SLOT + 1024


def test_wide_geometry_is_the_sources():
    assert cs.PLAIN_NFS == tuk._PLAIN_NF == (C["kPlainNF"], C["kWideNF"])
    assert cs.PLAIN_RING_SLOTS == {128: 0, 256: SLOTS}
    assert cs.PLAIN_SLOT_BYTES == SLOT
    code = re.sub(r"//[^\n]*", "", (CSRC / "plain_body.cuh").read_text())
    assert "launch_kernel(plain_wide_kernel<" in code
    assert "(size_t)kWideSmem" in code
    assert "SlotRing<kWideSlots, kWideSlotBytes, 4 * kGroups>" in code
    for name in ("plain_window.cu", "plain_feature.cu", "plain_site.cu"):
        text = (CSRC / name).read_text()
        assert "case 256:" in text and "launch_mix<256," in text, name


@pytest.mark.parametrize("depth", [1, 2, 3, 4])
def test_wide_smem_is_the_sources_and_fits(depth):
    smem = cs.plain_smem_bytes(depth, 256)
    assert smem == C["kWideSmem"] == 224_256
    assert smem <= SMEM_MAX


@pytest.mark.parametrize("head", tuk.HEADS)
def test_wide_staged_bytes(head):
    """Per block and mode the output head, biases and head weights, plus
    the ring's fills: on the bench's 3,182,784-site plane 4,144 full blocks
    of 4 tile rounds and a last one of 192 sites (3 tiles, 1 round), each
    round 4 passes x 16 fills per mode."""
    n, modes, depth = 3_182_784, 3, 2
    fills = cs.plain_ring_fills(n, modes=modes, depth=depth)
    assert cs.plain_grid(n) == 4145 and n - 4144 * 768 == 192
    assert fills == (4144 * 4 + 1) * modes * 4 * 8 * depth
    # both heads' w1 and b1 as bf16 pairs (stage_wide)
    per_mode = 2 * 64 * NF + 4 * (depth * NF + 64) + 2 * 5 * NF
    assert cs.plain_staged_bytes(n, modes=modes, depth=depth, head=head,
                                 nf=256) == (cs.plain_grid(n) * modes
                                             * per_mode + fills * SLOT)
    # a ragged last block runs only the rounds its live tiles need
    assert cs.plain_ring_fills(769, modes=1, depth=1) == (4 + 1) * 4 * 8


def test_wrapper_refuses_what_the_kernels_do_not_take():
    def stack(nf, depth, modes):
        bf = torch.bfloat16
        return {"w1t": torch.zeros(modes, nf, 4, dtype=bf),
                "b1": torch.zeros(modes, nf, dtype=bf),
                "hwt": torch.zeros(depth, modes, nf, nf, dtype=bf),
                "hb": torch.zeros(depth, modes, nf, dtype=bf),
                "w6t": torch.zeros(modes, 64, nf, dtype=bf),
                "b6": torch.zeros(modes, 64, dtype=bf)}

    taps = torch.zeros((5, 48), dtype=torch.bfloat16)
    for nf, depth, modes in ((64, 2, 3), (512, 2, 3), (256, 5, 3),
                             (256, 2, 7), (128, 5, 3)):
        with pytest.raises(NotImplementedError, match="nf=128 and nf=256"):
            tuk._launch_plain("plain_site", stack(nf, depth, modes), taps,
                              torch.zeros(16, 5), n=5, modes=modes, v=16,
                              mix=None, head="mxu")
    assert not any(tuk.LAUNCHES.values())
