"""Contact cache: cross-frame impulse persistence (``phyx_tpu/cache.py``).

The cache is a fixed-capacity SoA table keyed by ``(pi, pj)``.  Each frame
the fresh pair buffer joins against it, and each contact point takes the
cached impulses of the point with the same feature id.  One int64 key per
row replaces the reference's packed int32 keys and their fallbacks.
"""

from __future__ import annotations

import torch

from phyx_tpu_torch.broadphase import Pairs, pair_keys
from phyx_tpu_torch.narrowphase import Contacts
from phyx_tpu_torch.types import EMPTY, ContactCache


def lex_join(ka: torch.Tensor, kb: torch.Tensor,
             qa: torch.Tensor, qb: torch.Tensor):
    """Join query keys (qa, qb) against table keys (ka, kb).

    Returns ``(idx, hit)`` per query: the table row holding the same key
    and whether it exists (idx 0 when not).  Keys are unique within each
    table; EMPTY keys never match.  The table need not be sorted: it is
    sorted here, and each query binary-searches it."""
    tkey = pair_keys(ka, kb)
    tkey_s, perm = torch.sort(tkey)
    qkey = pair_keys(qa, qb)
    pos = torch.searchsorted(tkey_s, qkey)
    pos = torch.clamp(pos, max=tkey_s.shape[0] - 1)
    hit = (tkey_s[pos] == qkey) & (qa != EMPTY)
    idx = torch.where(hit, perm[pos], 0).to(torch.int32)
    return idx, hit


def warm_start_from_cache(contacts: Contacts, pairs: Pairs,
                          cache: ContactCache) -> Contacts:
    """Fill ``contacts.warm_n``/``warm_t`` from the previous frame's cache.
    Contact ``2p+k`` belongs to pair-slot ``p``; each point matches its
    feature id against the (up to two) cached ids of that pair."""
    P = pairs.pi.shape[0]
    posc, hit = lex_join(cache.pi, cache.pj, pairs.pi, pairs.pj)
    posc = posc.to(torch.int64)
    cfid = cache.fid[posc]                     # (P, 2)
    cn = cache.normal_impulse[posc]            # (P, 2)
    ct = cache.friction_impulse[posc]          # (P, 2)

    fid = contacts.fid.reshape(P, 2)
    live = hit[:, None] & (fid >= 0)
    match0 = (fid == cfid[:, 0:1]) & live
    match1 = (fid == cfid[:, 1:2]) & live
    warm_n = torch.where(match0, cn[:, 0:1],
                         torch.where(match1, cn[:, 1:2], 0.0))
    warm_t = torch.where(match0, ct[:, 0:1],
                         torch.where(match1, ct[:, 1:2], 0.0))
    return contacts.replace(warm_n=warm_n.reshape(-1),
                            warm_t=warm_t.reshape(-1))


def build_cache(contacts: Contacts, pairs: Pairs,
                accum_n: torch.Tensor, accum_t: torch.Tensor
                ) -> ContactCache:
    """Store this frame's accumulated impulses keyed by (pair, feature id):
    the new cache is the positional regrouping of the flat contact arrays,
    in the pair buffer's order (lex-sorted, or (slab, pi, pj) on the
    slab-major path) with EMPTY slots last; ``lex_join`` sorts it when it
    is read."""
    P = pairs.pi.shape[0]
    valid = contacts.valid.reshape(P, 2)
    return ContactCache(
        pi=pairs.pi,
        pj=pairs.pj,
        fid=torch.where(valid, contacts.fid.reshape(P, 2), -1),
        normal_impulse=torch.where(valid, accum_n.reshape(P, 2), 0.0),
        friction_impulse=torch.where(valid, accum_t.reshape(P, 2), 0.0),
    )
