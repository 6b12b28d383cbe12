"""The port's row NTT kernel (``csrc/ntt_row.cu``, wrapper ``ops/tile_ntt.py``)
on the CPU: its launch plan, its shared-memory swizzle (a permutation, and
free of bank conflicts for every warp access of every round, checked by
enumeration over the Python mirror of the kernel's index function), its
twiddle-pair table, a mirror of its round schedule against the plain
butterflies, its plain version against the TPU kernel it replaces (Pallas
interpret mode) at N = 256, the routing of small rings and the device
policy.  The CUDA kernel itself is held against its plain version on the
GPU by chip_smoke.py.  Integers, tolerance 0."""

import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from lattigo_tpu.ops import number_theory as nt
from lattigo_tpu.ops import tile_ntt as jtile
from lattigo_tpu.ops import u64 as ju
from lattigo_tpu.ops.ring import Ring as JRing
from lattigo_tpu_torch import _build, device
from lattigo_tpu_torch.ops import modred, pallas_ntt
from lattigo_tpu_torch.ops import tile_ntt as ttile
from lattigo_tpu_torch.ops import u64 as tu
from lattigo_tpu_torch.ops.ring import Ring as TRing

torch.set_num_threads(1)

LOG_NS = range(8, 15)
SMEM_MOST = 232_448  # bytes of shared memory an H100 block may use
SRC = open(os.path.join(_build.CSRC, "ntt_row.cu")).read()


def T(a):
    return tu.from_u64(a, "cpu")


def rand(moduli, limbs, batch, n, seed, mult):
    rng = np.random.default_rng(seed)
    x = np.empty((*batch, len(limbs), n), dtype=np.uint64)
    for k, l in enumerate(limbs):
        x[..., k, :] = rng.integers(0, mult * moduli[l], size=(*batch, n), dtype=np.uint64)
    return x


# --- device policy (F1) -----------------------------------------------------


@pytest.mark.parametrize("index", [0, 3])
def test_resolve_cuda_gives_an_indexed_device(monkeypatch, index):
    """"cuda" resolves to the current CUDA device with its index, which is
    what a tensor made there reports and what the wrappers compare with."""
    monkeypatch.setattr(torch.cuda, "current_device", lambda: index)
    want = torch.device("cuda", index)
    for spec in ("cuda", torch.device("cuda")):
        got = device.resolve(spec)
        assert got == want and got.index == index
    assert device.resolve("cuda:1") == torch.device("cuda", 1)
    assert device.resolve("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert device.resolve(None) == want
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        device.resolve(None)


# --- launch plan and the kernel's constants ---------------------------------


def test_constants_match_the_kernel_source():
    """The Python mirror's constants are the kernel's."""
    const = dict(re.findall(r"constexpr int (\w+) = ([^;,]+)[;,]", SRC))
    assert int(const["RADIX"]) == ttile.RADIX and int(const["SWZ"]) == ttile.SWZ
    assert 1 << int(const["MIN_LOG_N"]) == ttile.MIN_N == 256
    assert re.search(r"MAX_LOG_N = (\d+)", SRC).group(1) == "14" and ttile.MAX_N == 1 << 14
    assert const["BLOCK_WORDS"] == "1 << 14"
    assert int(const["MAX_THREADS"]) >= max(p.threads for _, p in PLANS)


# every plan the wrapper can pass: (N, plan) for transforms of 1 .. 2^20 rows
PLANS = sorted({(1 << e, ttile.launch_plan(1 << e, rows))
                for e in LOG_NS for rows in [None] + [1 << k for k in range(21)]})


@pytest.mark.parametrize("n,plan", PLANS)
def test_launch_plan(n, plan):
    """Every plan of every N the kernel takes: a block within the H100's
    limits holds whole rows of one limb, at most 4096 coefficients of
    several rows, one unit of a full round a thread at most."""
    assert 32 <= plan.threads <= 1024 and plan.threads % 32 == 0
    assert plan.smem_bytes <= SMEM_MOST
    assert plan.rows >= 1 and plan.rows & (plan.rows - 1) == 0
    assert plan.rows * n <= plan.smem_bytes // 8  # the block's capacity
    assert plan.rows * n <= max(n, 4096)
    assert plan.threads <= plan.rows * n >> ttile.RADIX  # no thread without a unit


@pytest.mark.parametrize("log_n", LOG_NS)
def test_launch_plan_keeps_the_card_busy(log_n):
    """Several rows a block only where the transform still has two blocks an
    SM; the wrapper passes the plan of the transform's rows."""
    n = 1 << log_n
    assert ttile.launch_plan(n).rows == max(1, 4096 // n)
    for rows in (1, 3, 216, 263, 264, 1000, 1 << 14, 1 << 20):
        plan = ttile.launch_plan(n, rows)
        assert plan.rows == 1 or -(-rows // plan.rows) >= 2 * 132
        assert plan.rows == ttile.launch_plan(n).rows or -(-rows // (2 * plan.rows)) < 2 * 132
    ring = TRing(n, nt.generate_ntt_primes(39, log_n, 3), device="cpu")
    plan = ttile.launch_plan(n, 5 * 2)
    ptrs, ints = ttile.launch_args(ring, (2, 0), True, 5 * 2)
    assert len(ptrs) == 3 and ints == (2, log_n, plan.rows, plan.threads, plan.smem_bytes, 1)
    assert 2 + len(ptrs) + 1 + len(ints) + 1 == len(_build.ENTRIES["ntt_row"].argtypes)


@pytest.mark.parametrize("n", [2, 128, 255, 3000, 1 << 15])
def test_launch_plan_refuses(n):
    with pytest.raises(ValueError):
        ttile.launch_plan(n)


# --- swizzle: a permutation, and conflict-free ------------------------------


def _half_warps_conflict_free(words: np.ndarray) -> bool:
    """words [..., 32] of 8-byte accesses of one warp instruction (-1: lane
    idle): each half-warp touches every bank pair (word mod 16) once, or the
    same word again."""
    for half in (words[..., :16], words[..., 16:]):
        for row in half.reshape(-1, 16):
            live = np.unique(row[row >= 0])
            if len(np.unique(live % 16)) != len(live):
                return False
    return True


@pytest.mark.parametrize("n,plan", PLANS)
def test_swizzle_is_a_conflict_free_permutation(n, plan):
    """For every plan of every N: the word of every block element is a
    permutation of the block's words, and every warp instruction of the
    contiguous passes and of every round (each element k of each unit
    iteration) is free of bank conflicts."""
    log_n = n.bit_length() - 1
    words = plan.rows * n
    b = np.arange(words)
    assert np.array_equal(np.sort(ttile.smem_word(b)), b)
    # a ragged block only idles lanes, so the full block is the worst case
    t = plan.threads
    it = np.arange(-(-words // t))[:, None] * t + np.arange(t)[None, :]  # contiguous passes
    w = np.where(it < words, ttile.smem_word(it), -1)
    assert _half_warps_conflict_free(w.reshape(-1, t // 32, 32))
    for e, stages in ttile.rounds(log_n):
        units = plan.rows << (log_n - stages)
        u = np.arange(-(-units // t) * t)
        el = ttile.unit_elements(log_n, e, stages, np.minimum(u, units - 1))
        w = np.where((u < units)[:, None], ttile.smem_word(el), -1)  # [u, k]
        w = w.reshape(-1, t // 32, 32, 1 << stages).transpose(0, 1, 3, 2)
        assert _half_warps_conflict_free(w), (e, stages)


@pytest.mark.parametrize("log_n", LOG_NS)
def test_rounds_cover_every_stage_once(log_n):
    """The rounds take log N stages, at most RADIX each, strides in order;
    every unit of a round holds distinct elements and the units of a row
    partition it."""
    rs = ttile.rounds(log_n)
    stages = [e + s - 1 - k for e, s in rs for k in range(s)]  # forward log_t order
    assert stages == list(range(log_n - 1, -1, -1))
    assert all(1 <= s <= ttile.RADIX for _, s in rs)
    assert len(rs) == -(-log_n // ttile.RADIX)  # one barrier a round
    n = 1 << log_n
    for e, s in rs:
        el = ttile.unit_elements(log_n, e, s, np.arange(2 * n >> s))  # two rows
        assert np.array_equal(np.sort(el.reshape(-1)), np.arange(2 * n))


# --- the round schedule, mirrored, against the butterflies -------------------


def _mirror(ring, x: torch.Tensor, limbs, inverse: bool, plan) -> torch.Tensor:
    """The kernel's schedule on tensors: blocks of the plan's rows of one
    limb, rounds over the units of ``unit_elements``, shared memory at
    ``smem_word``, twiddle pairs ``w[m + G ng + gg]``, the same
    arithmetic."""
    n, log_n = ring.n, ring.log_n
    pairs, consts = ttile._tables(ring, inverse)
    B = x.shape[0]
    out = torch.empty_like(x)
    fwd = ttile.rounds(log_n)
    order = fwd[::-1] if inverse else fwd
    for l, limb in enumerate(limbs):
        q, u0, ninv, ninvs = consts[limb]
        two_q = 2 * q
        w = pairs[limb]
        for b0 in range(0, B, plan.rows):
            here = min(plan.rows, B - b0)
            src = x[b0:b0 + here, l].reshape(-1)
            dst = torch.empty_like(src)
            s = torch.zeros(plan.rows * n, dtype=torch.int64)
            if inverse:
                b = torch.arange(here * n)
                s[ttile.smem_word(b)] = pallas_ntt._fold(pallas_ntt._fold(src[b], two_q), two_q)
            for idx, (e, stages) in enumerate(order):
                units = np.arange(here << (log_n - stages))
                el = torch.from_numpy(ttile.unit_elements(log_n, e, stages, units))
                G = torch.from_numpy((units & ((1 << (log_n - stages)) - 1)) >> e)
                v = src[el] if (idx == 0 and not inverse) else s[ttile.smem_word(el)]
                v = list(v.unbind(1))
                for st in range(stages):
                    log_t = e + st if inverse else e + stages - 1 - st
                    m = 1 << (log_n - log_t - 1)
                    d = 1 << st if inverse else 1 << (stages - 1 - st)
                    ng = (1 << stages) // (2 * d)
                    for gg in range(ng):
                        tw = w[m + G * ng + gg]
                        for kk in range(d):
                            i = gg * 2 * d + kk
                            j = i + d
                            if inverse:
                                U, V = v[i], v[j]
                                v[i] = pallas_ntt._fold(U + V, two_q)
                                v[j] = modred.mul_shoup(U + two_q - V, tw[:, 0], tw[:, 1], q)
                            else:
                                Uf = pallas_ntt._fold(v[i], two_q)
                                Vw = modred.mul_shoup(v[j], tw[:, 0], tw[:, 1], q)
                                v[i], v[j] = Uf + Vw, Uf + two_q - Vw
                v = torch.stack(v, dim=1)
                if inverse and idx == len(order) - 1:
                    dst[el] = modred.cred(modred.mul_shoup(v, ninv, ninvs, q), q)
                else:
                    s[ttile.smem_word(el)] = v
            if not inverse:
                b = torch.arange(here * n)
                dst[b] = modred.bred_add(s[ttile.smem_word(b)], q, u0)
            out[b0:b0 + here, l] = dst.reshape(here, n)
    return out


@pytest.mark.parametrize("log_n", LOG_NS)
def test_round_schedule_matches_butterflies(log_n):
    """The mirror of the kernel's schedule equals the plain butterflies
    (held against the JAX package by tests/test_torch_ring.py) on both
    directions, a batch of 5 under the plan of its rows and under the plan
    of a full card (several rows a block at N <= 2048, so ragged),
    non-prefix limbs, random inputs below 4q and every input at 4q - 1."""
    n = 1 << log_n
    bits = (60, 55, 45, 39, 60, 55, 45)[log_n - 8]
    moduli = nt.generate_ntt_primes(bits, log_n, 3)
    ring = TRing(n, moduli, device="cpu")
    limbs = (2, 0)
    x = rand(moduli, limbs, (5,), n, seed=log_n, mult=4)
    x[4] = (4 * np.array([moduli[l] for l in limbs], dtype=np.uint64) - 1)[:, None]
    for inverse in (False, True):
        want = ring._intt_simple(T(x), limbs) if inverse else ring._ntt_simple(T(x), limbs)
        for plan in {ttile.launch_plan(n, 10), ttile.launch_plan(n)}:
            assert torch.equal(_mirror(ring, T(x), limbs, inverse, plan), want), (inverse, plan)


# --- tables, routing, plain version -----------------------------------------


@pytest.mark.parametrize("inverse", [False, True])
def test_pair_table_interleaves_the_shoup_twiddles(inverse):
    ring = TRing(512, nt.generate_ntt_primes(50, 9, 3), device="cpu")
    pairs, consts = ttile._tables(ring, inverse)
    plain, shoup = ring.shoup_twiddles(inverse)
    assert pairs.shape == (3, 512, 2) and pairs.is_contiguous()
    np.testing.assert_array_equal(tu.to_u64(pairs[..., 0]), plain)
    np.testing.assert_array_equal(tu.to_u64(pairs[..., 1]), shoup)
    np.testing.assert_array_equal(tu.to_u64(pairs).reshape(3, -1)[:, 1::2], shoup)
    np.testing.assert_array_equal(tu.to_u64(consts)[:, 0], ring.moduli)
    assert ttile._tables(ring, inverse)[0] is pairs  # built once per ring and direction


@pytest.mark.parametrize("n,batch,route", [
    (16, (), "plain"), (64, (3,), "plain"), (128, (), "plain"), (128, (8, 2), "plain"),
    (256, (), "tile"), (256, (5,), "tile"), (512, (17,), "tile"), (1024, (), "tile"),
])
def test_small_rings_route(n, batch, route):
    """Below N = 256 every transform takes the plain schedule, from 256 on
    the row kernel (N < 4096: at every batch)."""
    ring = TRing(n, nt.generate_ntt_primes(40, n.bit_length() - 1, 1), compute_ntt_tables=False,
                 device="cpu")
    assert ring._route(torch.empty((*batch, 1, n), dtype=torch.int64, device="meta")) == route


def test_small_ring_transforms_take_the_plain_schedule(monkeypatch):
    """A ring of N = 128 transforms through _ntt_simple / _intt_simple,
    never through a kernel wrapper."""
    moduli = nt.generate_ntt_primes(45, 7, 2)
    ring = TRing(128, moduli, device="cpu")
    monkeypatch.setattr(ttile, "ntt_tile", lambda *a, **k: pytest.fail("row kernel called"))
    x = T(rand(moduli, (0, 1), (3,), 128, seed=1, mult=1))
    y = ring.ntt(x)
    assert torch.equal(y, ring._ntt_simple(x, (0, 1))) and torch.equal(ring.intt(y), x)


@pytest.fixture(scope="module")
def rings_256():
    moduli = nt.generate_ntt_primes(60, 8, 3)
    return moduli, JRing(256, moduli), TRing(256, moduli, device="cpu")


@pytest.mark.parametrize("limbs,batch,mult,inverse", [
    ((0, 1), (3,), 4, False), ((2, 0), (), 4, True), ((1,), (5,), 1, False),
])
def test_row_plain_matches_tile_kernel_n256(rings_256, limbs, batch, mult, inverse):
    """The TPU kernel in interpret mode at N = 256 against the wrapper's
    plain version (the CPU tensor's route)."""
    moduli, jr, tr = rings_256
    x = rand(moduli, limbs, batch, 256, seed=11 + mult, mult=mult)
    want = ju.to_u64(jax.tree.map(np.asarray, jtile.ntt_tile(
        jr, ju.from_u64(x), limbs, inverse=inverse, interpret=True)))
    before = _build.launch_counts()
    got = ttile.ntt_tile(tr, T(x), limbs, inverse=inverse)
    np.testing.assert_array_equal(tu.to_u64(got), want)
    assert _build.launch_counts() == before


def test_row_module_serves_cpu_tensors_without_nvcc(tmp_path):
    """tile_ntt imports and transforms a CPU tensor in a process that has no
    nvcc and no CUDA toolkit, building nothing."""
    code = (
        "import torch\n"
        "from lattigo_tpu_torch import _build\n"
        "from lattigo_tpu_torch.ops import tile_ntt, number_theory as nt\n"
        "from lattigo_tpu_torch.ops.ring import Ring\n"
        "r = Ring(256, nt.generate_ntt_primes(40, 8, 1), device='cpu')\n"
        "x = torch.arange(256, dtype=torch.int64).reshape(1, 256)\n"
        "y = tile_ntt.ntt_tile(r, x, (0,))\n"
        "assert torch.equal(tile_ntt.ntt_tile(r, y, (0,), inverse=True), x)\n"
        "assert sum(_build.launch_counts().values()) == 0 and not _build.LIBRARIES\n"
        "try:\n    _build._nvcc()\nexcept RuntimeError:\n    print('no nvcc')\n"
    )
    env = dict(os.environ, PATH=str(tmp_path), CUDA_HOME=str(tmp_path))
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "no nvcc"


def test_row_variants_apply_to_the_kernel_source():
    """Every diagnostic variant of lattigo_tpu_torch/tools/row_variants.py
    still finds the text it replaces in csrc/ntt_row.cu."""
    from lattigo_tpu_torch.tools import row_variants as rv

    assert rv.VARIANTS["kernel"] == []
    for name, subs in rv.VARIANTS.items():
        for old, new in subs:
            assert SRC.count(old) >= 1 and old != new, (name, old)
