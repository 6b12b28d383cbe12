"""The port's main paths: a BFV encrypted multiply + relinearization (the
reference's hottest path, bfv/evaluator.go:278-464 + :736-813), a CKKS
multiply + relinearize + rescale at the reference's largest set
(ckks/evaluator.go:1016-1133 + :901-995), the N-party private information
retrieval over threshold BFV of examples/dbfv_pir.py
(examples/dbfv/pir/pir.go), and an N-party encrypted two-layer sigmoid
network over threshold CKKS with a collective refresh between the layers
(examples/ckks_sigmoid.py's Chebyshev sigmoid on tests/test_dckks.py's
protocol sequence), bench.py's config #4 (a degree-31 Chebyshev sigmoid at
PN15QP880 through the per-op compiled ``JitEvaluator``), and the multi-rank
dry run of every threshold protocol on a party mesh with the cross-rank NTT
(``__graft_entry__.dryrun_multichip``).

``entry()`` returns the plain ``forward``, as ``__graft_entry__.entry()``
does: its caller compiles it (``tjit(forward)``).  The PIR cloud step
runs as one ``tjit`` program (a captured CUDA graph) on CUDA and eagerly on
the CPU, as examples/dbfv_pir.py does, or with its rows sharded over the
ranks of a ``launch.World`` (``DbfvPir.sharded_cloud``), as that example
shards them over a ``data`` mesh of several devices; the Chebyshev's ops
run through ``JitEvaluator``, as bench.py's do."""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import math
import time

import numpy as np
import torch
import torch.distributed as dist
from numpy.polynomial import chebyshev

from lattigo_tpu_torch import _build, convert
from lattigo_tpu_torch import device as _device
from lattigo_tpu_torch.models import bfv, ckks, dbfv, dckks
from lattigo_tpu_torch.ops import ring as ring_mod
from lattigo_tpu_torch.parallel import launch
from lattigo_tpu_torch.parallel import protocols as pp
from lattigo_tpu_torch.parallel.cross_ntt import ntt_four_step, sharded_ntt
from lattigo_tpu_torch.parallel.mesh import aggregate_mod, make_mesh, shard_batch
from lattigo_tpu_torch.tjit import tjit
from lattigo_tpu_torch.utils import serialization as ser
from lattigo_tpu_torch.utils.precision import precision_stats
from lattigo_tpu_torch.utils.prng import CRPGenerator


def _stack(cts: list, batch: tuple, make):
    """``cts`` (count = prod(batch)) stacked on leading axes ``batch``."""
    if not batch:
        return cts[0]
    stack = lambda k: torch.stack([c.value[k] for c in cts]).reshape(*batch, *cts[0].value[k].shape)
    return make([stack(k) for k in range(len(cts[0].value))], cts[0])


def _count(batch: tuple) -> int:
    return int(np.prod(batch, dtype=np.int64)) if batch else 1


def entry(device=None, params_idx: int = bfv.PN12QP109, batch=()):
    """Returns ``(forward, (ct0, ct1, rlk_swk))`` at a reference-shipped BFV
    parameter set: keys are generated, ``m`` and its reverse are encrypted,
    and ``forward(ct0, ct1, rlk_swk)`` is ``relinearize(mul(ct0, ct1))``.

    ``batch`` stacks that many independently encrypted ciphertext pairs on
    leading axes; the evaluator broadcasts over them.  ``device=None`` means
    the GPU and raises when there is none."""
    params = bfv.default_params(params_idx)
    kgen = bfv.KeyGenerator(params, device=device)
    enc = bfv.Encoder(params, device=device)
    ev = bfv.Evaluator(params, device=device)
    m = np.arange(params.n, dtype=np.uint64) % params.t

    sk, pk = kgen.gen_key_pair()
    rlk_swk = kgen.gen_relin_key(sk, 1).evakey[0]
    encryptor = bfv.Encryptor(params, pk=pk, device=device)

    def encrypt(msg) -> bfv.Ciphertext:
        cts = [encryptor.encrypt(enc.encode_uint(msg)) for _ in range(_count(batch))]
        return _stack(cts, batch, lambda value, _: bfv.Ciphertext(value))

    ct0, ct1 = encrypt(m), encrypt(m[::-1].copy())

    def forward(ct_a: bfv.Ciphertext, ct_b: bfv.Ciphertext, swk: bfv.SwitchingKey) -> bfv.Ciphertext:
        return ev.relinearize(ev.mul(ct_a, ct_b), bfv.EvaluationKey([swk]))

    forward.secret_key = sk  # lets a caller decrypt what forward returns
    return forward, (ct0, ct1, rlk_swk)


def entry_ckks(device=None, params_idx: int = ckks.PN16QP1761, batch=()):
    """Returns ``(forward, (ct0, ct1, rlk))`` at a reference-shipped CKKS
    parameter set, the twin of ``bench_ckks_pn16`` (bench.py): a sparse
    secret (hw = 192), its public and relinearization keys and the rotation
    keys for k = 1 and for conjugation are generated; two random complex
    vectors are encoded once and encrypted ``prod(batch)`` times each,
    stacked on leading axes; ``forward(ct0, ct1, rlk)`` is
    ``rescale(mul_relin(ct0, ct1, rlk))``.

    ``forward.secret_key``, ``.rotation_keys``, ``.values`` (the two
    vectors) and ``.evaluator`` let a caller rotate, decrypt and check what
    forward returns.  ``device=None`` means the GPU and raises when there is
    none."""
    params = ckks.default_params(params_idx)
    kgen = ckks.KeyGenerator(params, device=device, seed=3)
    sk, pk = kgen.gen_key_pair_sparse(hw=192)
    rlk = kgen.gen_relin_key(sk)
    rot_keys = ckks.RotationKeys()
    kgen.gen_rot("left", sk, 1, rot_keys)
    kgen.gen_rot("conjugate", sk, 0, rot_keys)
    enc = ckks.Encoder(params, device=device)
    ev = ckks.Evaluator(params, device=device)
    encryptor = ckks.Encryptor(params, pk=pk, device=device)
    rng = np.random.default_rng(3)
    values = tuple(rng.uniform(-1, 1, params.slots) + 1j * rng.uniform(-1, 1, params.slots)
                   for _ in range(2))

    def encrypt(pt) -> ckks.Ciphertext:
        cts = [encryptor.encrypt(pt) for _ in range(_count(batch))]
        return _stack(cts, batch, lambda value, c: ckks.Ciphertext(value, c.scale))

    ct0, ct1 = (encrypt(enc.encode(v)) for v in values)

    def forward(ct_a: ckks.Ciphertext, ct_b: ckks.Ciphertext, rlk_: ckks.EvaluationKey) -> ckks.Ciphertext:
        return ev.rescale(ev.mul_relin(ct_a, ct_b, rlk_))

    forward.secret_key = sk
    forward.rotation_keys = rot_keys
    forward.values = values
    forward.evaluator = ev
    return forward, (ct0, ct1, rlk)


def fold(proto, shares):
    """The parties' shares aggregated in turn by ``proto.aggregate``."""
    acc = shares[0]
    for s in shares[1:]:
        acc = proto.aggregate(acc, s)
    return acc


def fold_stacked(proto, stacked):
    """:func:`fold` of party-stacked shares: the share (a tensor, or a tuple
    of tensors) of a ``gen_share`` call on ``[parties, L_QP, N]`` secrets,
    party ``i`` at index ``i`` of the leading axis (bench.py's ``fold8``)."""
    first = stacked[0] if isinstance(stacked, tuple) else stacked
    party = lambda i: tuple(s[i] for s in stacked) if isinstance(stacked, tuple) else stacked[i]
    return fold(proto, [party(i) for i in range(first.shape[0])])


def rolled_variants(ct, n: int) -> list:
    """``n`` content-distinct ciphertexts of ``ct``'s signature (BFV or
    CKKS), each poly rolled by i along its coefficients (bench.py's
    ``rolled_ct_variants``); the first is ``ct``'s content."""
    return [dataclasses.replace(ct, value=[torch.roll(p, i, -1) for p in ct.value])
            for i in range(n)]


class DbfvPir:
    """The stages of the threshold-BFV private information retrieval, the
    twin of examples/dbfv_pir.py:53-213.  Each method is one stage;
    :meth:`run` drives them in order:

    ``ckg`` (collective public key) -> ``rkg`` (relinearization key, 3
    rounds) -> ``rtg`` (left power-of-two rotations and the row swap) ->
    ``encrypt`` (the database rows and a one-hot query under the collective
    key) -> ``cloud`` (select, ``inner_sum``, multiply with the rows, sum
    over the rows, relinearize; one batched pass over ``[n_rows, L, N]``
    stacks) -> ``cks`` (collective key switch to the requester's key) ->
    ``decrypt``.  ``compiled_cloud`` is ``cloud`` as one ``tjit`` program,
    which :meth:`run` calls on CUDA (examples/dbfv_pir.py:189-191); on the
    CPU it calls ``cloud``.  ``cloud`` is ``relinearize(cloud_partial(...))``:
    :meth:`sharded_cloud` runs ``cloud_partial`` on each rank's share of the
    rows, folds the partial sums across the ranks and relinearizes
    (examples/dbfv_pir.py:146-178 with several devices)."""

    wanted = 2  # the row the requester retrieves

    def __init__(self, params, device, n_parties: int, n_rows: int):
        if n_rows & (n_rows - 1) or n_rows <= self.wanted:
            raise ValueError("n_rows must be a power of two above the wanted row")
        self.params = params
        self.ctx = ctx = bfv.get_context(params, device)
        self.device = device = ctx.device
        self.n_parties, self.n_rows = n_parties, n_rows
        self.sks = [bfv.KeyGenerator(params, device=device, seed=i).gen_secret_key()
                    for i in range(n_parties)]
        sk_col = self.sks[0].sk
        for s in self.sks[1:]:
            sk_col = ctx.ring_qp.add(sk_col, s.sk)
        self.sk_col = bfv.SecretKey(sk_col)  # only for checks: no party holds it
        self.crp_gen = CRPGenerator(b"pir", ctx.ring_qp)
        self.crp_gen.seed(b"common-seed")
        self.enc = bfv.Encoder(params, device=device)
        self.ev = bfv.Evaluator(params, device=device)
        rng = np.random.default_rng(0)
        self.rows = [rng.integers(0, 256, params.n, dtype=np.uint64) for _ in range(n_rows)]
        self.compiled_cloud = tjit(self.cloud)

    def ckg(self) -> bfv.PublicKey:
        ckg = dbfv.CKGProtocol(self.params, device=self.device)
        crp = self.crp_gen.clock_poly()
        return ckg.gen_public_key(fold(ckg, [ckg.gen_share(sk.sk, crp) for sk in self.sks]), crp)

    def rkg(self) -> bfv.EvaluationKey:
        rkg = dbfv.RKGProtocol(self.params, device=self.device)
        crp = self.crp_gen.clock_polys(self.params.beta)
        sks = [sk.sk for sk in self.sks]
        ephs = [rkg.new_ephemeral_key() for _ in sks]
        r1 = fold(rkg, [rkg.gen_share_round_one(e, s, crp) for e, s in zip(ephs, sks)])
        r2 = fold(rkg, [rkg.gen_share_round_two(r1, s, crp) for s in sks])
        r3 = fold(rkg, [rkg.gen_share_round_three(r2, e, s) for e, s in zip(ephs, sks)])
        return rkg.gen_relinearization_key(r2, r3)

    def rtg(self) -> bfv.RotationKeys:
        rtg = dbfv.RTGProtocol(self.params, device=self.device)
        rot_keys = bfv.RotationKeys()
        turns = [("left", 1 << i) for i in range(self.params.log_n - 1)] + [("row", 0)]
        for rot_type, k in turns:
            crp = self.crp_gen.clock_polys(self.params.beta)
            shares = [rtg.gen_share(rot_type, k, sk.sk, crp) for sk in self.sks]
            rtg.finalize(rot_type, k, fold(rtg, shares), crp, rot_keys)
        return rot_keys

    def encrypt(self, pk: bfv.PublicKey):
        """Returns ``(query, rows, masks)``: the one-hot query's ciphertext,
        the rows' ciphertexts stacked on a leading axis, and the one-hot
        masks' plaintexts stacked likewise."""
        n = self.params.n
        encryptor = bfv.Encryptor(self.params, pk=pk, device=self.device)
        one_hot = lambda i: np.eye(1, n, i, dtype=np.uint64)[0]
        cts = [encryptor.encrypt(self.enc.encode_uint(r)) for r in self.rows]
        query = encryptor.encrypt(self.enc.encode_uint(one_hot(self.wanted)))
        rows = bfv.Ciphertext([torch.stack([ct.value[k] for ct in cts]) for k in range(2)])
        masks = torch.stack([self.enc.encode_uint(one_hot(r)).value for r in range(self.n_rows)])
        return query, rows, masks

    def cloud_partial(self, query: bfv.Ciphertext, rows: bfv.Ciphertext, masks: torch.Tensor,
                      rot_keys: bfv.RotationKeys) -> bfv.Ciphertext:
        """The sum over the rows given, before relinearization (see
        :func:`cloud_partial`)."""
        return cloud_partial(self.ev, query, rows, masks, rot_keys)

    def cloud(self, query: bfv.Ciphertext, rows: bfv.Ciphertext, masks: torch.Tensor,
              rlk: bfv.EvaluationKey, rot_keys: bfv.RotationKeys) -> bfv.Ciphertext:
        """sum_r inner_sum(query * mask_r) * row_r, relinearized
        (examples/dbfv_pir.py:159-178)."""
        return self.ev.relinearize(self.cloud_partial(query, rows, masks, rot_keys), rlk)

    def sharded_cloud(self, world: launch.World, query: bfv.Ciphertext, rows: bfv.Ciphertext,
                      masks: torch.Tensor, rlk: bfv.EvaluationKey, rot_keys: bfv.RotationKeys,
                      calls: int = 1) -> dict:
        """``cloud`` with the row axis sharded over the ranks of ``world``
        (one ``data`` group), the twin of examples/dbfv_pir.py:146-178 with
        several devices: each rank takes its ``n_rows / world.size`` rows and
        masks, runs ``cloud_partial`` on them (one ``tjit`` program on CUDA,
        eager on the CPU), folds the partial sums across the ranks
        (``mesh.aggregate_mod``) and relinearizes, replicated.  The inputs
        reach the ranks as host arrays, in one ``World.run``; each rank runs
        the cloud ``calls`` times (on CUDA the first captures its program).
        Returns ``result`` (the cloud's ciphertext on this object's device;
        equal on every rank, or this raises) and ``ranks``: by rank, its
        result (numpy), seconds by stage and call, the first call's kernel
        launches by stage, peak device memory (None on the CPU), rows and the
        distinct transforms it made."""
        if world.device_type != self.device.type:
            raise ValueError(f"a world on {world.device_type} for a PIR on {self.device.type}")
        if self.n_rows % world.size:
            raise ValueError(f"{self.n_rows} rows do not split over {world.size} ranks")
        ranks = world.run(_pir_cloud_rank, self.params, world.device_type,
                          convert.ciphertext_to_numpy(query), convert.ciphertext_to_numpy(rows),
                          convert.poly_to_numpy(masks), convert.switching_key_to_numpy(rlk.evakey[0]),
                          convert.bfv_rotation_keys_to_numpy(rot_keys), calls)
        first = ranks[0]["result"]
        for r, out in enumerate(ranks[1:], 1):
            if not all(np.array_equal(a, b) for a, b in zip(out["result"], first)):
                raise RuntimeError(f"sharded_cloud: rank {r}'s result differs from rank 0's")
        return dict(result=convert.ciphertext_from_numpy(first, self.device), ranks=ranks)

    def requester_key(self) -> bfv.SecretKey:
        return bfv.KeyGenerator(self.params, device=self.device, seed=10_000).gen_secret_key()

    def cks(self, result: bfv.Ciphertext, sk_req: bfv.SecretKey) -> bfv.Ciphertext:
        """Switches ``result`` from the parties' summed key to ``sk_req``:
        party 0 targets sk_req, every other party 0 (pir.go:355-370)."""
        cks = dbfv.CKSProtocol(self.params, device=self.device)
        zero = torch.zeros_like(sk_req.sk)
        shares = [cks.gen_share(sk.sk, zero if i else sk_req.sk, result)
                  for i, sk in enumerate(self.sks)]
        return cks.key_switch(fold(cks, shares), result)

    def decrypt(self, switched: bfv.Ciphertext, sk_req: bfv.SecretKey) -> np.ndarray:
        dec = bfv.Decryptor(self.params, sk_req, device=self.device)
        return self.enc.decode_uint(dec.decrypt(switched))

    def run(self, world: launch.World | None = None) -> np.ndarray:
        """Every stage in order; returns the retrieved row.  ``world``: an
        open ``launch.World`` on this object's device type whose size
        divides ``n_rows``, over which the cloud step is sharded
        (:meth:`sharded_cloud`)."""
        pk, rlk, rot_keys = self.ckg(), self.rkg(), self.rtg()
        query, rows, masks = self.encrypt(pk)
        if world is not None:
            result = self.sharded_cloud(world, query, rows, masks, rlk, rot_keys)["result"]
        else:
            cloud = self.compiled_cloud if self.device.type == "cuda" else self.cloud
            result = cloud(query, rows, masks, rlk, rot_keys)
        sk_req = self.requester_key()
        return self.decrypt(self.cks(result, sk_req), sk_req)


def cloud_partial(ev: bfv.Evaluator, query: bfv.Ciphertext, rows: bfv.Ciphertext,
                  masks: torch.Tensor, rot_keys: bfv.RotationKeys) -> bfv.Ciphertext:
    """sum_r inner_sum(query * mask_r) * row_r over the rows given (stacked
    on a leading axis of a power-of-two length), the degree-2 ciphertext of
    one row before relinearization (examples/dbfv_pir.py:159-176)."""
    rq = ev.ctx.ring_q
    R = masks.shape[0]
    # the query broadcast over the rows, materialised once
    q = bfv.Ciphertext([p.expand(R, *p.shape).contiguous() for p in query.value])
    sel = ev.inner_sum(ev.mul(q, bfv.Plaintext(masks)), rot_keys)
    vals = ev.mul(sel, rows).value  # degree 2, [R, L, N]
    while R > 1:  # log-depth tree of modular adds over the rows
        R //= 2
        vals = [rq.add(v[:R], v[R:]) for v in vals]
    return bfv.Ciphertext([v[0] for v in vals])


def _pir_cloud_rank(params, device_type: str, query, rows, masks, rlk, rot_keys,
                    calls: int) -> dict:
    """One rank of :meth:`DbfvPir.sharded_cloud`: a ``data`` mesh of every
    rank, this rank's rows and masks, then ``calls`` times the partial sum,
    the fold across the ranks and the relinearization.  The arguments are
    host arrays (``convert``'s formats); see ``sharded_cloud`` for what it
    returns.  It raises where a later call's result differs from the
    first's."""
    mesh = make_mesh(party=1, device_type=device_type)
    dev, group = mesh.device, mesh.group("data")
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    ev = bfv.Evaluator(params, device=dev)
    rq = ev.ctx.ring_q
    query = convert.ciphertext_from_numpy(query, dev)
    rows = convert.ciphertext_from_numpy(shard_batch(mesh, rows), dev)
    masks = convert.poly_from_numpy(shard_batch(mesh, masks), dev)
    rlk = bfv.EvaluationKey([convert.switching_key_from_numpy(*rlk, dev)])
    rot_keys = convert.bfv_rotation_keys_from_numpy(*rot_keys, dev)
    # The fold stays outside the program: gloo stages CUDA tensors through
    # the host, which a graph capture forbids.  NCCL ranks take the same
    # path, so both backends run one design.
    partial = functools.partial(cloud_partial, ev)
    if cuda:
        partial = tjit(partial)
    seconds = {"partial": [], "fold": [], "relinearize": []}
    counts = {}

    def stage(name, fn):
        ring_mod.reset_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        if cuda:
            torch.cuda.synchronize(dev)
        seconds[name].append(time.perf_counter() - t0)
        counts.setdefault(name, ring_mod.launch_counts())
        return out

    first = None
    with ring_mod.record_transforms() as made:
        for _ in range(calls):
            part = stage("partial", lambda: partial(query, rows, masks, rot_keys))
            folded = stage("fold", lambda: bfv.Ciphertext(
                [aggregate_mod(rq, p, group) for p in part.value]))
            out = stage("relinearize", lambda: ev.relinearize(folded, rlk))
            if first is None:
                first = out
            elif not all(torch.equal(a, b) for a, b in zip(out.value, first.value)):
                raise RuntimeError(f"sharded_cloud, rank {dist.get_rank()}: a later call's "
                                   "result differs from the first's")
    return dict(result=convert.ciphertext_to_numpy(first), seconds=seconds, counts=counts,
                peak_bytes=torch.cuda.max_memory_allocated(dev) if cuda else None,
                rows=masks.shape[0], transforms=ring_mod.distinct_transforms(made))


def entry_dbfv_pir(device=None, params_idx: int | bfv.Parameters = bfv.PN13QP218,
                   n_parties: int = 3, n_rows: int = 8) -> DbfvPir:
    """The threshold-BFV PIR at a reference-shipped BFV set (PN13QP218, the
    example's log N = 13, by default) or at the ``bfv.Parameters`` given as
    ``params_idx``; returns its stages (:class:`DbfvPir`), the parties'
    secret keys drawn.  ``run()`` retrieves row ``DbfvPir.wanted``.
    ``device=None`` means the GPU and raises when there is none."""
    params = params_idx if isinstance(params_idx, bfv.Parameters) else bfv.default_params(params_idx)
    return DbfvPir(params, device, n_parties, n_rows)


def sigmoid(x) -> float:
    """The logistic function of a slot's real part (examples/ckks_sigmoid.py)."""
    return 1 / (math.exp(-x.real) + 1)


def cheby_float64(cheby: ckks.ChebyshevInterpolation, x: np.ndarray) -> np.ndarray:
    """The interpolant ``cheby`` evaluated in float64 at real ``x``."""
    a, b = cheby.a.real, cheby.b.real
    coeffs = [cheby.coeffs[i].real for i in range(cheby.degree + 1)]
    return chebyshev.chebval((2 * x - a - b) / (b - a), coeffs)


class DckksSigmoid:
    """The stages of an N-party encrypted two-layer sigmoid network over
    threshold CKKS.  Each method is one stage; :meth:`run` drives them in
    order:

    ``ckg`` (collective public key) -> ``rkg`` (relinearization key, 3
    rounds) -> ``rtg`` (left rotation by 1, conjugation) -> ``encrypt``
    (each party's vector under the collective key) -> ``layer1`` (the sum,
    the degree-7 Chebyshev sigmoid on [-4, 4], plus its rotation by one
    slot, squared) -> ``refresh`` (collective bootstrap back to the top
    level) -> ``layer2`` (the sigmoid on [0, 4]) -> ``pcks`` (public-key
    switch to a requester's key) -> ``decrypt``.

    Every share crosses from its party to the aggregator as bytes, through
    the reference-format codec of its protocol (``utils/serialization``);
    ``wire_bytes`` counts them by protocol."""

    def __init__(self, params, device, n_parties: int):
        self.params = params
        self.ctx = ctx = ckks.get_context(params, device)
        self.device = device = ctx.device
        self.n_parties = n_parties
        self.sks = [ckks.KeyGenerator(params, device=device, seed=i).gen_secret_key()
                    for i in range(n_parties)]
        sk_col = self.sks[0].sk
        for s in self.sks[1:]:
            sk_col = ctx.ring_qp.add(sk_col, s.sk)
        self.sk_col = ckks.SecretKey(sk_col)  # only for checks: no party holds it
        self.crp_gen = CRPGenerator(b"dckks-sigmoid", ctx.ring_qp)
        self.crp_gen.seed(b"common-seed")
        self.enc = ckks.Encoder(params, device=device)
        self.ev = ckks.Evaluator(params, device=device)
        rng = np.random.default_rng(1)
        self.xs = [rng.uniform(-4 / 3, 4 / 3, params.slots) for _ in range(n_parties)]
        self.cheby1 = ckks.approximate(sigmoid, -4, 4, 7)
        self.cheby2 = ckks.approximate(sigmoid, 0, 4, 7)
        self.wire_bytes: dict[str, int] = {}

    def _send(self, protocol: str, codec: str, share, *head):
        """``share`` from its party to the aggregator: to bytes and back
        through ``<codec>_share_to_bytes`` / ``_from_bytes``."""
        data = getattr(ser, codec + "_share_to_bytes")(*head, share)
        self.wire_bytes[protocol] = self.wire_bytes.get(protocol, 0) + len(data)
        out = getattr(ser, codec + "_share_from_bytes")(data, self.device)
        return out[-1] if head else out

    def _gather(self, proto, protocol: str, codec: str, shares, *head):
        return fold(proto, [self._send(protocol, codec, s, *head) for s in shares])

    def ckg(self) -> ckks.PublicKey:
        proto = dckks.CKGProtocol(self.params, device=self.device)
        crp = self.crp_gen.clock_poly()
        shares = [proto.gen_share(sk.sk, crp) for sk in self.sks]
        return proto.gen_public_key(self._gather(proto, "ckg", "ckg", shares), crp)

    def rkg(self) -> ckks.EvaluationKey:
        proto = dckks.RKGProtocol(self.params, device=self.device)
        crp = self.crp_gen.clock_polys(self.params.beta())
        sks = [sk.sk for sk in self.sks]
        ephs = [proto.new_ephemeral_key() for _ in sks]
        r1 = self._gather(proto, "rkg", "rkg_round1",
                          [proto.gen_share_round_one(e, s, crp) for e, s in zip(ephs, sks)])
        r2 = self._gather(proto, "rkg", "rkg_round2",
                          [proto.gen_share_round_two(r1, s, crp) for s in sks])
        r3 = self._gather(proto, "rkg", "rkg_round3",
                          [proto.gen_share_round_three(r2, e, s) for e, s in zip(ephs, sks)])
        return proto.gen_relinearization_key(r2, r3)

    def rtg(self) -> ckks.RotationKeys:
        proto = dckks.RTGProtocol(self.params, device=self.device)
        rot_keys = ckks.RotationKeys()
        for rot_type, k, code in (("left", 1, ser.ROTATION_LEFT), ("conjugate", 0, ser.ROTATION_ROW)):
            crp = self.crp_gen.clock_polys(self.params.beta())
            shares = [proto.gen_share(rot_type, k, sk.sk, crp) for sk in self.sks]
            proto.finalize(rot_type, k, self._gather(proto, "rtg", "rtg", shares, k, code),
                           crp, rot_keys)
        return rot_keys

    def encrypt(self, pk: ckks.PublicKey) -> list[ckks.Ciphertext]:
        """Party i's vector ``xs[i]`` under the collective key."""
        return [ckks.Encryptor(self.params, pk=pk, device=self.device, seed=100 + i)
                .encrypt(self.enc.encode(x)) for i, x in enumerate(self.xs)]

    def layer1(self, cts: list[ckks.Ciphertext], rlk: ckks.EvaluationKey,
               rot_keys: ckks.RotationKeys) -> ckks.Ciphertext:
        """(s + rotate(s, 1))^2 with s = sigmoid(x_0 + ... + x_{n-1})."""
        ev = self.ev
        x = cts[0]
        for ct in cts[1:]:
            x = ev.add(x, ct)
        s = ckks.evaluate_cheby_eco(ev, x, self.cheby1, rlk)
        return ckks.algorithms.power_of_2(ev, ev.add(s, ev.rotate_columns(s, 1, rot_keys)), 1, rlk)

    def refresh_masks(self, proto: dckks.RefreshProtocol, level: int) -> list:
        """Each party's smudging mask planes (host big integers)."""
        return [proto.gen_mask_planes(self.n_parties, level) for _ in self.sks]

    def refresh_finish(self, proto: dckks.RefreshProtocol, ct: ckks.Ciphertext,
                       masks: list) -> ckks.Ciphertext:
        """The parties' shares on the device, over the wire, and the
        recode and re-encryption at the top level."""
        crs = self.crp_gen.clock_poly()[: self.ctx.ring_q.L]
        shares = [proto.gen_share_masked(sk.sk, ct.value[1], crs, *m)
                  for sk, m in zip(self.sks, masks)]
        return proto.finalize(ct, crs, self._gather(proto, "refresh", "refresh", shares))

    def refresh(self, ct: ckks.Ciphertext) -> ckks.Ciphertext:
        """Collective refresh of ``ct`` (level restored to the top)."""
        proto = dckks.RefreshProtocol(self.params, device=self.device)
        return self.refresh_finish(proto, ct, self.refresh_masks(proto, ct.level))

    def layer2(self, ct: ckks.Ciphertext, rlk: ckks.EvaluationKey) -> ckks.Ciphertext:
        return ckks.evaluate_cheby_eco(self.ev, ct, self.cheby2, rlk)

    def requester_key(self) -> tuple[ckks.SecretKey, ckks.PublicKey]:
        return ckks.KeyGenerator(self.params, device=self.device, seed=10_000).gen_key_pair()

    def pcks(self, ct: ckks.Ciphertext, pk_req: ckks.PublicKey) -> ckks.Ciphertext:
        proto = dckks.PCKSProtocol(self.params, device=self.device)
        shares = [proto.gen_share(sk.sk, pk_req, ct) for sk in self.sks]
        return proto.key_switch(self._gather(proto, "pcks", "pcks", shares), ct)

    def decrypt(self, ct: ckks.Ciphertext, sk_req: ckks.SecretKey) -> np.ndarray:
        dec = ckks.Decryptor(self.params, sk_req, device=self.device)
        return self.enc.decode(dec.decrypt(ct)).real

    def want(self, exact: bool = True) -> np.ndarray:
        """What :meth:`run` computes, in float64: with the sigmoid itself
        (``exact``) or with the two Chebyshev interpolants the layers
        evaluate."""
        if exact:
            f1 = f2 = lambda v: 1 / (1 + np.exp(-v))
        else:
            f1, f2 = (lambda v, c=c: cheby_float64(c, v) for c in (self.cheby1, self.cheby2))
        s = f1(sum(self.xs))
        return f2((s + np.roll(s, -1)) ** 2)

    def run(self) -> np.ndarray:
        """Every stage in order; returns the decrypted output slots."""
        pk, rlk, rot_keys = self.ckg(), self.rkg(), self.rtg()
        hidden = self.refresh(self.layer1(self.encrypt(pk), rlk, rot_keys))
        sk_req, pk_req = self.requester_key()
        return self.decrypt(self.pcks(self.layer2(hidden, rlk), pk_req), sk_req)


def entry_dckks_sigmoid(device=None, params_idx: int | ckks.Parameters = ckks.PN14QP438,
                        n_parties: int = 3) -> DckksSigmoid:
    """The threshold-CKKS sigmoid network at a reference-shipped CKKS set
    (PN14QP438, the reference's default, by default) or at the
    ``ckks.Parameters`` given as ``params_idx``; returns its stages
    (:class:`DckksSigmoid`), the parties' secret keys drawn.  ``run()``
    gives the output slots; ``want()`` what they should be.  ``device=None``
    means the GPU and raises when there is none."""
    params = params_idx if isinstance(params_idx, ckks.Parameters) else ckks.default_params(params_idx)
    return DckksSigmoid(params, device, n_parties)


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Cheby31:
    """The stages of bench.py's config #4 (``bench_ckks_cheby31``,
    bench.py:413-472): a degree-31 Chebyshev interpolant of the sigmoid on
    [-8, 8] evaluated by ``evaluate_cheby_fast`` through the per-op
    compiled ``JitEvaluator``.  :meth:`run` drives them in order:

    ``keygen`` (a sparse secret of Hamming weight 128, its public and
    relinearization keys) -> ``encrypt`` (uniform slots in [-8, 8] from
    ``np.random.default_rng(3)``) -> ``rolled_variants`` (content-distinct
    copies of one signature) -> ``evaluate`` -> ``decrypt``."""

    def __init__(self, params, device):
        self.params = params
        self.ctx = ckks.get_context(params, device)
        self.device = device = self.ctx.device
        self.enc = ckks.Encoder(params, device=device)
        self.ev = ckks.JitEvaluator(params, device=device)
        self.cheby = ckks.approximate(sigmoid, -8, 8, 31)
        self.x = np.random.default_rng(3).uniform(-8, 8, params.slots)

    def keygen(self) -> tuple[ckks.SecretKey, ckks.PublicKey, ckks.EvaluationKey]:
        kgen = ckks.KeyGenerator(self.params, device=self.device, seed=3)
        sk, pk = kgen.gen_key_pair_sparse(hw=128)
        return sk, pk, kgen.gen_relin_key(sk)

    def encrypt(self, pk: ckks.PublicKey) -> ckks.Ciphertext:
        encryptor = ckks.Encryptor(self.params, pk=pk, device=self.device, seed=3)
        return encryptor.encrypt(self.enc.encode(self.x.astype(np.complex128)))

    def evaluate(self, ct: ckks.Ciphertext, rlk: ckks.EvaluationKey, ev=None) -> ckks.Ciphertext:
        """The interpolant at ``ct`` through ``ev`` (the ``JitEvaluator`` by
        default)."""
        return ckks.evaluate_cheby_fast(self.ev if ev is None else ev, ct, self.cheby, rlk)

    def decrypt(self, ct: ckks.Ciphertext, sk: ckks.SecretKey) -> np.ndarray:
        return self.enc.decode(ckks.Decryptor(self.params, sk, device=self.device).decrypt(ct)).real

    def want(self, exact: bool = True) -> np.ndarray:
        """The sigmoid at the slots (``exact``), or the interpolant in
        float64."""
        return 1 / (1 + np.exp(-self.x)) if exact else cheby_float64(self.cheby, self.x)

    def op_traces(self) -> int:
        """Programs the evaluator holds, over every op (bench.py:462)."""
        return sum(f.trace_count() for f in self.ev._jops.values())

    def run(self, n_variants: int = 4) -> dict:
        """Every stage; returns bench.py's numbers: ``capture_s`` (the first
        evaluation, every program's warm-up and capture included: the twin
        of ``compile_s``), ``evals_per_s`` over the other ``n_variants - 1``
        content-distinct ciphertexts, ``op_traces``, and the first result's
        median bits against the interpolant and the sigmoid."""
        sk, pk, rlk = self.keygen()
        cts = rolled_variants(self.encrypt(pk), n_variants)
        t0 = time.perf_counter()
        out = self.evaluate(cts[0], rlk)
        _synchronize(self.device)
        capture_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for ct in cts[1:]:
            self.evaluate(ct, rlk)
        _synchronize(self.device)
        per = (time.perf_counter() - t0) / (n_variants - 1)
        got = self.decrypt(out, sk)
        return dict(capture_s=capture_s, evals_per_s=1 / per, slots_per_s=self.params.slots / per,
                    op_traces=self.op_traces(), level=out.level,
                    bits_vs_chebyshev=precision_stats(got, self.want(exact=False)).median_bits,
                    bits_vs_sigmoid=precision_stats(got, self.want()).median_bits)


def entry_cheby31(device=None, params_idx: int | ckks.Parameters = ckks.PN15QP880) -> Cheby31:
    """bench.py's config #4 at a reference-shipped CKKS set (PN15QP880:
    N = 32768, Q = 50 + 17 x 40 bit, P = 3 x 50, by default) or at the
    ``ckks.Parameters`` given as ``params_idx`` (it takes 7 levels);
    returns its stages (:class:`Cheby31`).  ``device=None`` means the GPU
    and raises when there is none."""
    params = (params_idx if isinstance(params_idx, ckks.Parameters)
              else ckks.default_params(params_idx))
    return Cheby31(params, device)


def _digest(*tensors) -> str:
    h = hashlib.blake2b(digest_size=16)
    for t in tensors:
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()


def _dryrun_rank(params, device_type: str) -> dict:
    """One rank of :func:`dryrun_multichip`: party ``rank`` of a mesh of
    every rank on the ``party`` axis.  Returns its stage seconds, kernel
    launches by stage, digests of what each stage made (equal on every rank
    when the combined shares are) and the distinct transforms it made
    (``(moduli, shape, limbs, inverse, route)``)."""
    n_party = dist.get_world_size()
    mesh = make_mesh(n_party, party=n_party, device_type=device_type)
    group, dev = mesh.group("party"), mesh.device
    ctx = bfv.get_context(params, dev)
    seconds, counts, digests = {}, {}, {}

    def stage(name, fn):
        ring_mod.reset_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        seconds[name] = time.perf_counter() - t0
        counts[name] = ring_mod.launch_counts()
        return out

    def check(ok: bool, what: str) -> None:
        if not ok:
            raise RuntimeError(f"dryrun_multichip, rank {dist.get_rank()}: {what}")

    with ring_mod.record_transforms() as calls:
        sks = [bfv.KeyGenerator(params, device=dev, seed=30 + i).gen_secret_key()
               for i in range(n_party)]
        sk_list = [s.sk for s in sks]
        acc = sk_list[0]
        for s in sk_list[1:]:
            acc = ctx.ring_qp.add(acc, s)
        sk_col = bfv.SecretKey(acc)  # only for checks: no party holds it
        crpg = CRPGenerator(b"dryrun", ctx.ring_qp)
        crpg.seed(b"seed")

        crp = crpg.clock_poly()
        pk = stage("ckg", lambda: pp.ckg_mesh(dbfv.CKGProtocol(params, device=dev, seed=1),
                                              group, sk_list, crp))
        crp_b = crpg.clock_polys(params.beta)
        rlk = stage("rkg", lambda: pp.rkg_mesh(dbfv.RKGProtocol(params, device=dev, seed=5),
                                               group, sk_list, crp_b))
        rot_keys = stage("rtg", lambda: pp.rtg_mesh(
            dbfv.RTGProtocol(params, device=dev, seed=6), group, "left", 1, sk_list, crp_b,
            bfv.RotationKeys()))
        digests.update(pk=_digest(*pk.pk), rlk=_digest(rlk.evakey[0].key0, rlk.evakey[0].key1),
                       rtg=_digest(rot_keys.left[1].key0, rot_keys.left[1].key1))

        enc = bfv.Encoder(params, device=dev)
        msg = np.arange(params.n, dtype=np.uint64) % np.uint64(params.t)
        ct = stage("encrypt", lambda: bfv.Encryptor(params, pk=pk, device=dev).encrypt(
            enc.encode_uint(msg)))
        dec_col = bfv.Decryptor(params, sk_col, device=dev)
        decode = lambda c, dec=dec_col: enc.decode_uint(dec.decrypt(c))

        # one transform of c1 split over the ranks, exact against the ring's
        rq = ctx.ring_q
        c1 = rq.intt(ct.value[1])

        def cross_ntt():
            fwd = ntt_four_step(rq, c1, group)
            check(torch.equal(fwd, rq.ntt(c1)), "the cross-rank NTT differs from ring_q.ntt")
            back = ntt_four_step(rq, fwd, group, inverse=True)
            check(torch.equal(back, c1), "the cross-rank inverse NTT differs from ring_q.intt")

        stage("cross_ntt", cross_ntt)
        ev = bfv.Evaluator(params, device=dev)
        want_sq = msg * msg % np.uint64(params.t)
        ct_sq = stage("mul_relin", lambda: ev.relinearize(ev.mul(ct, ct), rlk))
        check((decode(ct_sq) == want_sq).all(), "mul + relinearize does not decrypt exactly")

        def sharded():
            with sharded_ntt(group, min_n=params.n):
                return ev.relinearize(ev.mul(ct, ct), rlk)

        ct_sq2 = stage("mul_relin_sharded", sharded)
        check(all(torch.equal(a, b) for a, b in zip(ct_sq.value, ct_sq2.value)),
              "mul + relinearize inside sharded_ntt differs from the unsharded one")
        check((decode(ct_sq2) == want_sq).all(),
              "mul + relinearize inside sharded_ntt does not decrypt exactly")
        check(sum(counts["mul_relin_sharded"].values()) == 0,
              "a kernel was launched inside sharded_ntt")

        ct_rot = stage("rotate", lambda: ev.rotate_columns(ct, 1, rot_keys))
        half = params.n >> 1
        check((decode(ct_rot) == np.concatenate([np.roll(msg[:half], -1),
                                                  np.roll(msg[half:], -1)])).all(),
              "rotate_columns(1) does not decrypt exactly")

        sk_out, pk_out = bfv.KeyGenerator(params, device=dev, seed=2).gen_key_pair()
        ct2 = stage("pcks", lambda: pp.pcks_mesh(dbfv.PCKSProtocol(params, device=dev, seed=3),
                                                 group, sk_list, pk_out, ct))
        check((decode(ct2, bfv.Decryptor(params, sk_out, device=dev)) == msg).all(),
              "PCKS does not decrypt exactly under the target key")

        crs = crpg.clock_poly()
        ct3 = stage("refresh", lambda: pp.refresh_mesh(
            dbfv.RefreshProtocol(params, device=dev, seed=4), group, sk_list, ct, crs))
        check((decode(ct3) == msg).all(), "refresh does not decrypt exactly")
        digests.update(mul_relin=_digest(*ct_sq.value), pcks=_digest(*ct2.value),
                       refresh=_digest(*ct3.value))
    return dict(seconds=seconds, counts=counts, digests=digests,
                transforms=ring_mod.distinct_transforms(calls))


def dryrun_multichip(n_devices: int, device=None, backend: str = "nccl",
                     params_idx: int | bfv.Parameters = bfv.PN12QP109,
                     world: launch.World | None = None) -> dict:
    """The twin of ``__graft_entry__.dryrun_multichip``: the full
    threshold-BFV pipeline on a mesh of ``n_devices`` ranks, one party a
    rank, every protocol aggregated by all-gather + modular fold:

      CKG -> 3-round RKG -> RTG (left by 1) -> encrypt under the collective
      key -> cross-rank four-step NTT round trip of c1 -> mul + relinearize
      -> the same inside ``sharded_ntt`` (every transform cross-rank, no
      kernel) -> rotate_columns(1) -> PCKS to a fresh key -> collective
      refresh,

    each checked by exact decryption under the summed or target key on every
    rank, and every rank's keys and ciphertexts equal (dbfv/dbfv_test.go's
    summed-key verification).  ``params_idx`` is a BFV set index
    (PN12QP109 by default) or a ``bfv.Parameters``.

    Rank r runs on ``cuda:(r % device_count)`` (``device=None`` or a CUDA
    device; None raises without a GPU) or on the CPU (``device="cpu"``).
    ``backend`` is ``"nccl"`` (one card a rank: it raises with more ranks
    than cards) or ``"gloo"``; it is never switched.  ``world``: an open
    ``launch.World`` of ``n_devices`` ranks with that backend to run on
    (default: a new one for this call).  Returns the JAX function's "OK"
    line and, by rank, each stage's seconds and kernel launches and the
    transforms made."""
    params = params_idx if isinstance(params_idx, bfv.Parameters) else bfv.default_params(params_idx)
    device_type = _device.resolve(device).type
    launch.check_backend(n_devices, backend, device_type)
    if world is None:
        if device_type == "cuda":
            _build.build()  # once here, not once a rank
        ranks = launch.run(n_devices, _dryrun_rank, params, device_type,
                           backend=backend, device_type=device_type)
    elif (world.size, world.backend, world.device_type) != (n_devices, backend, device_type):
        raise ValueError(f"a world of {world.size} {world.backend} ranks on {world.device_type}"
                         f" for {n_devices} {backend} ranks on {device_type}")
    else:
        ranks = world.run(_dryrun_rank, params, device_type)
    for r, out in enumerate(ranks[1:], 1):
        if out["digests"] != ranks[0]["digests"]:
            raise RuntimeError(f"dryrun_multichip: rank {r}'s keys or ciphertexts differ from "
                               "rank 0's")
    label = (f"log N = {params.log_n}" if isinstance(params_idx, bfv.Parameters)
             else ("PN12QP109", "PN13QP218", "PN14QP438", "PN15QP880")[params_idx])
    ok = (f"dryrun_multichip OK: {n_devices}-party mesh at {label}, CKG -> RKG(3 rounds) -> "
          f"RTG -> encrypt -> cross-chip four-step NTT roundtrip -> mul+relin -> rotate -> "
          f"PCKS -> refresh, exact decryptions (N={params.n}, "
          f"L={len(params.qi) + len(params.pi)})")
    return dict(ok=ok, backend=backend, device_type=device_type, parties=n_devices,
                digests=ranks[0]["digests"], seconds=[r["seconds"] for r in ranks],
                counts=[r["counts"] for r in ranks], transforms=[r["transforms"] for r in ranks])
