"""Self-speculative drafter of the PyTorch port
(paddle_tpu_torch/models/spec_decode.py) against the JAX package's
(paddle_tpu/models/spec_decode.py), on the CPU.

The same admit/note/draft/drop/clear sequence goes through both
``SuffixDrafter``s (with and without a radix cache, each over its own
package's ``PrefixCache`` and ``PagedKVCache``): every draft and every
request's context, n-gram index and radix cursor must be equal.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

import paddle_tpu  # noqa: F401  (the JAX package's settings)
from paddle_tpu.models import paged_kv as jpk
from paddle_tpu.models import radix_cache as jrc
from paddle_tpu.models import spec_decode as jsd
from paddle_tpu_torch.models import paged_kv as tpk
from paddle_tpu_torch.models import radix_cache as trc
from paddle_tpu_torch.models import spec_decode as tsd

BS = 4


def _caches():
    kw = dict(num_layers=1, num_blocks=40, block_size=BS, kv_heads=1, head_dim=2, batch=4,
              max_blocks_per_seq=10)
    return (jrc.PrefixCache(jpk.PagedKVCache(dtype=jnp.float32, **kw)),
            trc.PrefixCache(tpk.PagedKVCache(dtype=torch.float32, device="cpu", **kw)))


def _state(d):
    return {rid: (list(c.tokens), {k: list(v) for k, v in c.index.items()}, c.n_full, c.parent)
            for rid, c in d._reqs.items()}


def _script(d, pc, rng):
    """A drafting run: a repetitive prompt, generated tokens that keep
    re-using its n-grams, a second request, drops and a clear."""
    pattern = rng.randint(0, 20, 6).astype(np.int32)
    prompt = np.concatenate([pattern, pattern, pattern[:3]])
    d.admit(0, prompt)
    yield d.draft(0)
    yield d.draft(0, 2)
    yield d.draft(0, 100)                    # capped at lookahead
    yield d.draft(7)                         # unknown request: empty
    for tok in list(pattern[3:]) + list(rng.randint(0, 20, 5)):
        d.note(0, tok)
        yield d.draft(0)
    d.admit(1, rng.randint(0, 20, 9).astype(np.int32))
    yield d.draft(1)
    d.note(1, 3)
    d.note(5, 3)                             # unknown request: ignored
    yield d.draft(1, 0)
    yield len(d)
    if pc is not None:
        # request 2's prompt is registered as a chain: a request with its
        # head drafts the chain's continuation
        full = np.concatenate([prompt, rng.randint(0, 20, 9).astype(np.int32)])
        need = np.zeros(4, np.int64)
        need[2] = len(full)
        pc._pager.ensure_capacity(need)
        yield pc.register(full, len(full), pc._pager._tables_np[2])
        d.admit(2, full[:6])
        yield d.draft(2)
        yield d.draft(2, 3)
        d.note(2, int(full[6]))
        yield d.draft(2)
        d.note(2, 99)                        # leaves the chain: n-gram source
        yield d.draft(2)
    d.drop(0)
    d.drop(0)
    yield len(d)
    yield _state(d)
    d.clear()
    yield len(d), d.draft(1)


def _as_lists(x):
    if isinstance(x, np.ndarray):
        assert x.dtype == np.int32
        return x.tolist()
    if isinstance(x, (list, tuple)):
        return [_as_lists(v) for v in x]
    return x


@pytest.mark.parametrize("radix", [False, True])
@pytest.mark.parametrize("lookahead,max_ngram,min_ngram", [(8, 3, 1), (4, 2, 2), (16, 4, 1)])
def test_same_calls_same_drafts(radix, lookahead, max_ngram, min_ngram):
    jpc, tpc = _caches() if radix else (None, None)
    jd = jsd.SuffixDrafter(lookahead, max_ngram, min_ngram, prefix_cache=jpc)
    td = tsd.SuffixDrafter(lookahead, max_ngram, min_ngram, prefix_cache=tpc)
    got_j = list(_script(jd, jpc, np.random.RandomState(lookahead)))
    got_t = list(_script(td, tpc, np.random.RandomState(lookahead)))
    assert _as_lists(got_t) == _as_lists(got_j)
    assert any(len(x) for x in got_t if isinstance(x, np.ndarray))


def test_ngram_bounds_checked():
    for mod in (jsd, tsd):
        with pytest.raises(ValueError, match="max_ngram"):
            mod.SuffixDrafter(max_ngram=1, min_ngram=2)


def test_drafter_uses_the_ports_digest(monkeypatch):
    """The radix cursor is the port's own ``_digest`` (no JAX import): a
    constant digest forced into both modules keeps the drafts equal."""
    assert tsd._digest is trc._digest
    for mod in (jrc, trc, jsd, tsd):
        monkeypatch.setattr(mod, "_digest", lambda parent, tokens: b"c")
    jpc, tpc = _caches()
    jd = jsd.SuffixDrafter(8, prefix_cache=jpc)
    td = tsd.SuffixDrafter(8, prefix_cache=tpc)
    got_j = list(_script(jd, jpc, np.random.RandomState(3)))
    got_t = list(_script(td, tpc, np.random.RandomState(3)))
    assert _as_lists(got_t) == _as_lists(got_j)
