"""Threshold protocols over a party group, one party a rank.

Counterpart of ``lattigo_tpu/parallel/protocols.py``.  Rank r computes
party r's share of a dbfv/dckks protocol, and aggregation is the all-gather
+ modular fold of :mod:`lattigo_tpu_torch.parallel.mesh`, leaf by leaf over
the share's tensors (SURVEY.md section 5's "Aggregate = all-reduce"
mapping, in place of the reference's in-process share passing).

The ranks run one program (SPMD).  Every rank builds the same protocol
objects with the same seeds and makes the protocol's own draws (ephemeral
keys, refresh masks) for every party in the same order, so the replicated
state stays in step; each then takes its own party's slice.  A party's
noise comes from its own generator, seeded from the protocol's seed, the
index of the run and the party (:func:`party_seed`): the twin of the JAX
package's ``jax.random.split(proto._next_key(), n_party)``.
"""

from __future__ import annotations

import numpy as np
import torch.distributed as dist

from lattigo_tpu_torch.ops import samplers
from lattigo_tpu_torch.parallel.mesh import gather


def party_seed(seed: int, run: int, party: int) -> int:
    """The seed of ``party``'s noise in run ``run`` of a protocol seeded
    with ``seed``."""
    state = np.random.SeedSequence([seed, run, party]).generate_state(1, np.uint64)[0]
    return int(state >> np.uint64(1))


def _party_generator(proto, party: int):
    run = proto.party_runs
    proto.party_runs += 1
    return samplers.make_generator(proto.ctx.device, party_seed(proto.seed, run, party))


def _leaves(tree) -> list:
    if isinstance(tree, (tuple, list)):
        return [leaf for t in tree for leaf in _leaves(t)]
    return [tree]


def _rebuild(tree, leaves):
    """``tree``'s structure over the tensors of the iterator ``leaves``."""
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(t, leaves) for t in tree)
    return next(leaves)


def mesh_aggregate(proto, share, group=None):
    """The parties' shares (tensors, or tuples / lists of them) folded with
    the protocol's own ``aggregate`` in rank order, on every rank."""
    gathered = [gather(leaf, group) for leaf in _leaves(share)]
    per_party = [_rebuild(share, iter(g[p] for g in gathered)) for p in range(len(gathered[0]))]
    acc = per_party[0]
    for s in per_party[1:]:
        acc = proto.aggregate(acc, s)
    return acc


def run_on_party_mesh(proto, group, gen_fn, party_args, rep_args):
    """The aggregated share of ``gen_fn`` over the party ``group`` (None:
    the world), on every rank.

    ``gen_fn(*party_slices, *rep_args)`` is the protocol's GenShare;
    ``party_args`` is a list of per-party lists (e.g. secret keys), of which
    rank r takes element r; ``rep_args`` a list of replicated values (CRP,
    ciphertext polys, public keys).  The share's noise comes from rank r's
    party generator."""
    n_party, r = dist.get_world_size(group), dist.get_rank(group)
    for pa in party_args:
        if len(pa) != n_party:
            raise ValueError(f"{len(pa)} party arguments for {n_party} parties")
    with proto.using_generator(_party_generator(proto, r)):
        share = gen_fn(*[pa[r] for pa in party_args], *rep_args)
    return mesh_aggregate(proto, share, group)


def collective_keygen_mesh(ckg, sk_shares, crp, group=None):
    """The collective public-key share (e_i - sk_i * crp, summed over the
    parties), on every rank.  ``sk_shares``: the parties' secret keys (a
    list, or a tensor stacked on a leading party axis)."""
    return run_on_party_mesh(ckg, group, ckg.gen_share, [sk_shares], [crp])


# -- per-protocol conveniences (dbfv and dckks alike) -----------------------


def cks_mesh(cks, group, sk_in_list, sk_out_list, ct):
    """Collective key switch on the party group -> switched ciphertext."""
    combined = run_on_party_mesh(
        cks, group,
        lambda sk_in, sk_out, *ct_polys: cks.gen_share(sk_in, sk_out, _rebuild_ct(ct, ct_polys)),
        [sk_in_list, sk_out_list], list(ct.value),
    )
    return cks.key_switch(combined, ct)


def pcks_mesh(pcks, group, sk_list, pk, ct):
    """Public-key collective key switch to ``pk`` -> switched ciphertext."""
    combined = run_on_party_mesh(
        pcks, group,
        lambda sk, pk0, pk1, *ct_polys: pcks.gen_share(sk, type(pk)((pk0, pk1)),
                                                       _rebuild_ct(ct, ct_polys)),
        [sk_list], [pk.pk[0], pk.pk[1], *ct.value],
    )
    return pcks.key_switch(combined, ct)


def rtg_mesh(rtg, group, rot_type, k, sk_list, crp, rot_keys):
    """Collective rotation key ``(rot_type, k)``, written into ``rot_keys``."""
    combined = run_on_party_mesh(
        rtg, group, lambda sk, crp_: rtg.gen_share(rot_type, k, sk, crp_), [sk_list], [crp])
    rtg.finalize(rot_type, k, combined, crp, rot_keys)
    return rot_keys


def refresh_mesh(refresh, group, sk_list, ct, crs):
    """dbfv collective refresh (dbfv/public_refresh.go); dckks refreshes go
    through :func:`refresh_mesh_dckks`."""
    combined = run_on_party_mesh(
        refresh, group,
        lambda sk, crs_, *ct_polys: refresh.gen_share(sk, _rebuild_ct(ct, ct_polys), crs_),
        [sk_list], [crs, *ct.value],
    )
    return refresh.finalize(ct, crs, combined)


def refresh_mesh_dckks(refresh, group, sk_list, ct, crs):
    """dckks collective refresh: every rank builds every party's host
    big-integer masks (``RefreshProtocol.gen_mask_planes``, in party order,
    from the protocol's own generator), then each runs its party's device
    share (``gen_share_masked``) (dckks/public_refresh.go:44-151)."""
    n_party = dist.get_world_size(group)
    masks = [refresh.gen_mask_planes(n_party, ct.level) for _ in range(n_party)]
    combined = run_on_party_mesh(
        refresh, group,
        lambda sk, m_lvl, m_full, crs_, c1: refresh.gen_share_masked(sk, c1, crs_, m_lvl, m_full),
        [sk_list, [m[0] for m in masks], [m[1] for m in masks]], [crs, ct.value[1]],
    )
    return refresh.finalize(ct, crs, combined)


def rkg_mesh(rkg, group, sk_list, crp):
    """3-round collective relinearization key; each round's all-gather is
    the barrier before the next (dbfv/relinkey_gen.go:212-348).  Every rank
    draws every party's ephemeral key, in party order."""
    n_party = dist.get_world_size(group)
    u_eph = [rkg.new_ephemeral_key() for _ in range(n_party)]
    r1 = run_on_party_mesh(
        rkg, group, lambda u_e, sk, crp_: rkg.gen_share_round_one(u_e, sk, crp_),
        [u_eph, sk_list], [crp])
    r2 = run_on_party_mesh(
        rkg, group, lambda sk, r1_, crp_: rkg.gen_share_round_two(r1_, sk, crp_),
        [sk_list], [r1, crp])
    r3 = run_on_party_mesh(
        rkg, group, lambda u_e, sk, r2_: rkg.gen_share_round_three(r2_, u_e, sk),
        [u_eph, sk_list], [r2])
    return rkg.gen_relinearization_key(r2, r3)


def ckg_mesh(ckg, group, sk_list, crp):
    """Collective public key."""
    return ckg.gen_public_key(collective_keygen_mesh(ckg, sk_list, crp, group), crp)


def _rebuild_ct(template, polys):
    """The polys in the template's ciphertext type, its metadata (scale,
    NTT flag) kept."""
    out = template.copy()
    out.value = list(polys)
    return out
