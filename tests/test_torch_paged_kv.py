"""Paged KV cache of the PyTorch port (paddle_tpu_torch/models/paged_kv.py)
against the JAX package's (paddle_tpu/models/paged_kv.py), on the CPU.

Allocator: the same call sequence on both ``PagedKVCache``s must leave the
same tables, free list and reference counts. Pool functions: the same numpy
pools, tables and values go to both; writes must leave every block bit for
bit as the JAX package leaves it (padding rows and invalid lanes included),
and attention must agree at fp32 within rtol/atol 1e-5. The allocator's fault
points (``paged_kv.ensure``, ``paged_kv.cow``) raise the same typed errors
and leave the same books.

``block_multihead_attention`` (the reference-surface functional over the
pool, ``incubate.nn.functional``): prefill then decode against the JAX
function and the dense oracle of tests/test_paged_kv.py:142-230, within
1e-5; the same unsupported arguments raise.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

import paddle_tpu as paddle
import paddle_tpu.incubate.nn.functional as JF
from paddle_tpu.analysis import faultinject as jfi
from paddle_tpu.models import paged_kv as jpk
import paddle_tpu_torch.incubate.nn.functional as TF
from paddle_tpu_torch.analysis import faultinject as tfi
from paddle_tpu_torch.models import paged_kv as tpk


def _pair(num_blocks=8, block_size=4, kv_heads=2, head_dim=8, batch=2,
          max_blocks_per_seq=4, quantized=False, layers=1):
    kw = dict(num_layers=layers, num_blocks=num_blocks, block_size=block_size,
              kv_heads=kv_heads, head_dim=head_dim, batch=batch,
              max_blocks_per_seq=max_blocks_per_seq, quantized=quantized)
    return (jpk.PagedKVCache(dtype=jnp.float32, **kw),
            tpk.PagedKVCache(dtype=torch.float32, device="cpu", **kw))


def _same_books(j, t):
    np.testing.assert_array_equal(t._tables_np, j._tables_np)
    np.testing.assert_array_equal(t.block_tables.numpy(), np.asarray(j.block_tables))
    assert t.block_tables.dtype == torch.int32
    assert t._free == j._free
    np.testing.assert_array_equal(t._refs, j._refs)


def _same_pools(jpools, tpools):
    for je, te in zip(jpools, tpools):
        for a, b in zip(je, te):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def _filled(j, t, seed):
    """Both pagers' layer-0 pools set to the same random contents (the null
    block too, so a write that should not happen shows)."""
    rng = np.random.RandomState(seed)
    if j.quantized:
        vals = [rng.randint(-127, 128, j.k[0].shape).astype(np.int8),
                rng.rand(*j.k_scale[0].shape).astype(np.float32),
                rng.randint(-127, 128, j.v[0].shape).astype(np.int8),
                rng.rand(*j.v_scale[0].shape).astype(np.float32)]
    else:
        vals = [rng.randn(*j.k[0].shape).astype(np.float32) for _ in range(2)]
    return ([tuple(jnp.asarray(v) for v in vals)],
            [tuple(torch.from_numpy(v.copy()) for v in vals)])


class TestAllocatorAgainstJax:
    def test_grant_exhaust_and_free(self):
        j, t = _pair(num_blocks=6)
        for c in (j, t):
            c.ensure_capacity([4, 9])
        _same_books(j, t)
        for c in (j, t):
            with pytest.raises(RuntimeError, match="pool exhausted"):
                c.ensure_capacity([16, 16])
        # the grants made before the pool ran dry reached the device tables
        _same_books(j, t)
        for c in (j, t):
            c.free_sequence(0)
            c.ensure_capacity([0, 16])
        _same_books(j, t)

    def test_nothing_to_grant_keeps_the_device_tables(self, monkeypatch):
        _, t = _pair()
        t.ensure_capacity([5, 2])
        before = t.block_tables.clone()
        uploads = []
        monkeypatch.setattr(t, "_upload", lambda: uploads.append(1))
        t.ensure_capacity([8, 4])      # fits the blocks already owned
        assert uploads == [] and torch.equal(t.block_tables, before)

    def test_retain_release_adopt(self):
        j, t = _pair()
        for c in (j, t):
            c.ensure_capacity([8, 0])
            shared = [int(b) for b in c._tables_np[0] if b > 0]
            c.retain_blocks(shared)
            c.free_sequence(0)
            c.adopt_blocks(1, shared)
        _same_books(j, t)
        for c in (j, t):
            c.free_sequence(1)
            assert c.release_blocks(shared) == len(shared)
        _same_books(j, t)

    @pytest.mark.parametrize("call,match", [
        (lambda c: c.retain_blocks([3]), "free"),
        (lambda c: c.retain_blocks([0]), "out of range"),
        (lambda c: (c.ensure_capacity([4, 4]), c.adopt_blocks(1, [int(c._tables_np[0, 0])])),
         "already holds"),
        (lambda c: c.adopt_blocks(0, [5]), "cannot adopt"),
        (lambda c: c.adopt_blocks(0, [1] * 5), "longer than"),
        (lambda c: (c.ensure_capacity([4, 0]), c.place_blocks(0, [2])), "already holds"),
    ])
    def test_errors_match(self, call, match):
        j, t = _pair()
        for c in (j, t):
            with pytest.raises(ValueError, match=match):
                call(c)
        _same_books(j, t)

    def test_take_and_place_blocks(self):
        j, t = _pair()
        for c in (j, t):
            c.ensure_capacity([4, 0])
            assert c.take_blocks(100) is None
            assert c.take_blocks(0) is None
            blks = c.take_blocks(3)
            c.place_blocks(1, blks)
        _same_books(j, t)

    def test_cow_under_pool_exhaustion(self):
        j, t = _pair(num_blocks=3, kv_heads=1, head_dim=2, max_blocks_per_seq=2)
        jpools, tpools = _filled(j, t, 0)
        for c, pools, exc in ((j, jpools[0], jpk.CowPoolExhausted),
                              (t, tpools[0], tpk.CowPoolExhausted)):
            c.ensure_capacity([4, 0])
            blk = int(c._tables_np[0, 0])
            c.retain_blocks([blk])
            c.ensure_capacity([4, 4])          # the last free block
            with pytest.raises(exc, match="copy-on-write"):
                c.make_positions_exclusive([0], [3], pools)
            assert c._refs[blk] == 2 and not c._free
        _same_books(j, t)

    def test_cow_partial_exhaustion_applies_completed_copies(self):
        j, t = _pair(num_blocks=5, kv_heads=1, head_dim=2, batch=3, max_blocks_per_seq=2)
        jpools, tpools = _filled(j, t, 1)
        got = {}
        for key, c, pools, exc in (("jax", j, jpools[0], jpk.CowPoolExhausted),
                                   ("torch", t, tpools[0], tpk.CowPoolExhausted)):
            c.ensure_capacity([4, 4, 0])
            b0, b1 = int(c._tables_np[0, 0]), int(c._tables_np[1, 0])
            c.retain_blocks([b0, b1])
            c.ensure_capacity([4, 4, 4])       # one free block remains
            with pytest.raises(exc, match="copy-on-write") as ei:
                c.make_positions_exclusive([0, 1], [3, 3], pools)
            got[key] = ei.value.pools
            # row 0 was remapped before the pool ran dry; row 1 is still
            # shared and retryable
            assert c._refs[b0] == 1 and int(c._tables_np[1, 0]) == b1 and c._refs[b1] == 2
        _same_books(j, t)
        _same_pools([got["jax"]], [got["torch"]])
        # the port wrote its pools in place: the exception carries them, and
        # row 0's private copy holds the data of the block it shared
        assert all(a is b for a, b in zip(got["torch"], tpools[0]))
        new0 = int(t._tables_np[0, 0])
        np.testing.assert_array_equal(tpools[0][0][new0].numpy(), tpools[0][0][b0].numpy())

    def test_positions_exclusive_copies_once_per_block(self):
        j, t = _pair(kv_heads=1, head_dim=2)
        jpools, tpools = _filled(j, t, 2)
        out = {}
        for key, c, pools in (("jax", j, jpools[0]), ("torch", t, tpools[0])):
            c.ensure_capacity([8, 0])
            c.retain_blocks([int(c._tables_np[0, 1])])
            free0 = len(c._free)
            out[key] = c.make_positions_exclusive([0, 0], [5, 6], pools)
            assert len(c._free) == free0 - 1
        _same_books(j, t)
        _same_pools([out["jax"]], [out["torch"]])

    def test_random_workload_books_and_pools(self):
        """Grants, frees, forks and copy-on-write in a random order: the same
        books on both sides after every step, and the same pool contents
        (every copy-on-write copies the same blocks)."""
        rng = np.random.RandomState(0)
        B, bs, max_blocks = 6, 4, 5
        j, t = _pair(num_blocks=B * max_blocks + 1, block_size=bs, kv_heads=1,
                     head_dim=2, batch=B, max_blocks_per_seq=max_blocks)
        jpools, tpools = _filled(j, t, 3)
        jp, tp = jpools[0], tpools[0]
        lens = np.zeros(B, np.int64)
        for step in range(200):
            op = rng.randint(4)
            if op == 0:
                b = rng.randint(B)
                if lens[b] + 1 < bs * max_blocks:
                    lens[b] += 1
                    for c in (j, t):
                        c.ensure_capacity(lens)
            elif op == 1:
                b = rng.randint(B)
                for c in (j, t):
                    c.free_sequence(b)
                lens[b] = 0
            elif op == 2:
                parents = rng.randint(0, B, B)
                for c in (j, t):
                    c.fork_rows(parents)
                lens = lens[parents]
            else:
                pos = int(lens.max()) if lens.max() > 0 else 0
                for c in (j, t):
                    c.ensure_capacity(np.maximum(lens, pos + 1) * (lens > 0))
                jp = j.make_tail_exclusive(pos, jp)
                tp = t.make_tail_exclusive(pos, tp)
            _same_books(j, t)
        _same_pools([jp], [tp])

    def test_alloc_blocks(self):
        assert tpk.alloc_blocks(3, 29, 8) == jpk.alloc_blocks(3, 29, 8) == 4

    @pytest.mark.parametrize("under_inference_mode", [False, True])
    def test_device_tables_keep_their_identity(self, under_inference_mode):
        """``block_tables`` is one tensor for the pager's life, overwritten in
        place (a captured CUDA graph reads it by address): after grants,
        exhaustion, frees, retain/adopt, take/place, forks and copy-on-write
        it is the same tensor at the same address, and its values are the
        JAX pager's. A pager built under inference mode updates outside it
        too."""
        if under_inference_mode:
            with torch.inference_mode():
                j, t = _pair(num_blocks=12, batch=3, kv_heads=1, head_dim=2)
        else:
            j, t = _pair(num_blocks=12, batch=3, kv_heads=1, head_dim=2)
        jpools, tpools = _filled(j, t, 4)
        tables, ptr = t.block_tables, t.block_tables.data_ptr()
        host = {}

        def check():
            assert t.block_tables is tables and tables.data_ptr() == ptr
            _same_books(j, t)

        for key, c, pools in (("jax", j, jpools[0]), ("torch", t, tpools[0])):
            c.ensure_capacity([5, 9, 0])
            with pytest.raises(RuntimeError, match="pool exhausted"):
                c.ensure_capacity([16, 16, 16])
            c.free_sequence(2)
            c.free_sequence(1)
            shared = [int(b) for b in c._tables_np[0] if b > 0]
            c.retain_blocks(shared)
            c.free_sequence(0)
            c.adopt_blocks(2, shared)
            blks = c.take_blocks(2)
            c.place_blocks(0, blks)
            host[key] = c.make_positions_exclusive([2, 2], [1, 5], pools)
            c.fork_rows([1, 1, 2])
            c.ensure_capacity([9, 1, 8])
            host[key] = c.make_tail_exclusive(8, host[key])
            if key == "torch":
                check()
        _same_pools([host["jax"]], [host["torch"]])
        # the host mirror may change right after an upload: the device copy
        # was taken from a snapshot
        t._tables_np[:] = 0
        assert tables.numpy().any()
        np.testing.assert_array_equal(tables.numpy(), np.asarray(j.block_tables))


def _tables(rows):
    return np.asarray(rows, np.int32)


# block tables of 3 sequences over a 10-block pool, block size 4; row 2 has
# one block, so its later positions point at the null block 0
_TABLES = _tables([[3, 7, 1], [5, 2, 9], [8, 0, 0]])


def _pools(quantized, seed, nb=10, bs=4, kv=2, d=8):
    rng = np.random.RandomState(seed)
    if quantized:
        return [rng.randint(-127, 128, (nb, bs, kv, d)).astype(np.int8),
                rng.rand(nb, bs, kv).astype(np.float32),
                rng.randint(-127, 128, (nb, bs, kv, d)).astype(np.int8),
                rng.rand(nb, bs, kv).astype(np.float32)]
    return [rng.randn(nb, bs, kv, d).astype(np.float32) for _ in range(2)]


def _new_values(quantized, seed, lead, kv=2, d=8):
    rng = np.random.RandomState(seed)
    if quantized:
        return [rng.randint(-127, 128, lead + (kv, d)).astype(np.int8),
                rng.rand(*lead, kv).astype(np.float32),
                rng.randint(-127, 128, lead + (kv, d)).astype(np.int8),
                rng.rand(*lead, kv).astype(np.float32)]
    return [rng.randn(*lead, kv, d).astype(np.float32) for _ in range(2)]


def _both(fn_j, fn_t, pools, *args):
    """Run a write on the same numpy inputs in both packages; the port's
    must return the very tensors it was handed, written in place."""
    jt = [jnp.asarray(a) for a in pools]
    tt = [torch.from_numpy(a.copy()) for a in pools]
    jargs = [jnp.asarray(a) for a in args]
    targs = [torch.from_numpy(np.ascontiguousarray(a)) for a in args]
    if len(pools) == 4:
        jo = fn_j(*jt, *jargs[:-4], *jargs[-4:])
        to = fn_t(*tt, *targs[:-4], *targs[-4:])
    else:
        jo = fn_j(*jt, *jargs)
        to = fn_t(*tt, *targs)
    assert all(a is b for a, b in zip(to, tt))
    for a, b in zip(jo, to):
        assert b.dtype == {np.dtype(np.int8): torch.int8,
                           np.dtype(np.float32): torch.float32}[np.asarray(a).dtype]
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    return to


class TestPagedWritesAgainstJax:
    @pytest.mark.parametrize("quantized", [False, True])
    def test_decode_write(self, quantized):
        fj = jpk.paged_write_decode_int8 if quantized else jpk.paged_write_decode
        ft = tpk.paged_write_decode_int8 if quantized else tpk.paged_write_decode
        lens = np.array([5, 0, 3], np.int32)
        _both(fj, ft, _pools(quantized, 0), _TABLES, lens,
              *_new_values(quantized, 1, (3,)))

    @pytest.mark.parametrize("quantized", [False, True])
    @pytest.mark.parametrize("lens", [[6, 9, 3], [12, 1, 0], [0, 0, 0]])
    def test_prefill_write_padding_rows_write_nothing(self, quantized, lens):
        """Positions at or past a row's length are padding: in the JAX
        package the scatter drops them; here they must leave every block,
        the null block included, as the JAX package leaves it."""
        fj = jpk.paged_write_prefill_int8 if quantized else jpk.paged_write_prefill
        ft = tpk.paged_write_prefill_int8 if quantized else tpk.paged_write_prefill
        S = 12
        _both(fj, ft, _pools(quantized, 2), _TABLES, np.array(lens, np.int32),
              *_new_values(quantized, 3, (3, S)))

    @pytest.mark.parametrize("quantized", [False, True])
    @pytest.mark.parametrize("valid", [
        [True, False, True, False, True, False],
        [False, True, True, True, True, True],
        [False] * 6,
        [True] * 6,
    ])
    def test_mixed_write_invalid_lanes_write_nothing(self, quantized, valid):
        """Invalid lanes aim at real blocks of other lanes (the same table row
        and position as a valid lane, too): they must write nothing."""
        fj = jpk.paged_write_mixed_int8 if quantized else jpk.paged_write_mixed
        ft = tpk.paged_write_mixed_int8 if quantized else tpk.paged_write_mixed
        slots = np.array([0, 0, 1, 1, 2, 1])
        positions = np.array([4, 4, 2, 9, 1, 5], np.int32)
        _both(fj, ft, _pools(quantized, 4), _TABLES[slots], positions,
              np.array(valid), *_new_values(quantized, 5, (6,)))


class TestPagedAttentionAgainstJax:
    @pytest.mark.parametrize("n_q,n_kv", [(4, 2), (4, 4), (8, 1)])
    @pytest.mark.parametrize("quantized", [False, True])
    def test_decode_attention(self, n_q, n_kv, quantized):
        rng = np.random.RandomState(n_q * 10 + n_kv)
        pools = _pools(quantized, 6, kv=n_kv)
        q = rng.randn(3, n_q, 8).astype(np.float32)
        lens = np.array([10, 4, 2], np.int32)     # multi-block and ragged
        fj = jpk.paged_attention_decode_int8 if quantized else jpk.paged_attention_decode
        ft = tpk.paged_attention_decode_int8 if quantized else tpk.paged_attention_decode
        for scale in (None, 0.3):
            want = np.asarray(fj(jnp.asarray(q), *map(jnp.asarray, pools),
                                 jnp.asarray(_TABLES), jnp.asarray(lens), scale=scale))
            got = ft(torch.from_numpy(q), *map(torch.from_numpy, pools),
                     torch.from_numpy(_TABLES), torch.from_numpy(lens), scale=scale)
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)

    def test_float64_stays_float64(self):
        pools = [p.astype(np.float64) for p in _pools(False, 7)]
        q = np.random.RandomState(8).randn(3, 4, 8)
        lens = np.array([9, 5, 1], np.int32)
        want = np.asarray(jpk.paged_attention_decode(
            jnp.asarray(q), *map(jnp.asarray, pools), jnp.asarray(_TABLES), jnp.asarray(lens)))
        got = tpk.paged_attention_decode(torch.from_numpy(q), *map(torch.from_numpy, pools),
                                         torch.from_numpy(_TABLES), torch.from_numpy(lens))
        assert got.dtype == torch.float64
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)


class TestSpillRoundTrip:
    @pytest.mark.parametrize("quantized", [False, True])
    def test_roundtrip_bit_exact_and_other_blocks_alone(self, quantized):
        j, t = _pair(num_blocks=9, quantized=quantized, layers=2)
        leaves = ((lambda c, i: (c.k[i], c.k_scale[i], c.v[i], c.v_scale[i])) if quantized
                  else (lambda c, i: (c.k[i], c.v[i])))
        jpools = [leaves(j, i) for i in range(2)]
        tpools = [leaves(t, i) for i in range(2)]
        rng = np.random.RandomState(0)
        blks = [2, 5, 7]
        want = []
        for _ in range(2):
            entry = []
            for leaf in jpools[0]:
                shape = (len(blks),) + tuple(leaf.shape[1:])
                entry.append(rng.randint(-128, 128, shape).astype(np.int8)
                             if leaf.dtype == jnp.int8 else rng.rand(*shape).astype(np.float32))
            want.append(tuple(entry))
        jpools = j.write_block_contents(jpools, blks, want)
        out = t.write_block_contents(tpools, blks, want)
        assert out is tpools
        _same_pools(jpools, tpools)
        got = tpk.read_blocks(tpools, blks)
        ref = jpk.read_blocks(jpools, blks)
        for wl, gl, rl in zip(want, got, ref):
            assert len(gl) == len(wl)
            for w, g, r in zip(wl, gl, rl):
                assert g.device.type == "cpu" and g.numpy().dtype == w.dtype
                np.testing.assert_array_equal(g.numpy(), w)
                np.testing.assert_array_equal(g.numpy(), r)
        others = [b for b in range(1, 9) if b not in blks]
        for leaf in tpk.read_blocks(tpools, others)[0]:
            assert not leaf.any()


class TestFaultPointsAgainstJax:
    @pytest.fixture(autouse=True)
    def _clean(self):
        jfi.reset()
        tfi.reset()
        yield
        jfi.reset()
        tfi.reset()

    def test_ensure_flag_raises_without_touching_the_free_list(self):
        j, t = _pair()
        for c, fi in ((j, jfi), (t, tfi)):
            c.ensure_capacity([4, 0])
            fi.arm("paged_kv.ensure", action="flag", nth=2)
            c.ensure_capacity([4, 0])              # the first call: no trip
            with pytest.raises(RuntimeError, match="injected fault"):
                c.ensure_capacity([8, 4])
            c.ensure_capacity([8, 4])              # nth fires once
        assert tfi.trips() == jfi.trips() == [("paged_kv.ensure", "flag")]
        _same_books(j, t)

    def test_cow_flag_raises_with_the_live_pools(self):
        j, t = _pair(num_blocks=6, kv_heads=1, head_dim=2, max_blocks_per_seq=2)
        jpools, tpools = _filled(j, t, 2)
        for c, pools, fi, exc in ((j, jpools[0], jfi, jpk.CowPoolExhausted),
                                  (t, tpools[0], tfi, tpk.CowPoolExhausted)):
            c.ensure_capacity([4, 0])
            c.retain_blocks([int(c._tables_np[0, 0])])
            fi.arm("paged_kv.cow", action="flag", nth=1)
            with pytest.raises(exc, match="injected fault") as ei:
                c.make_positions_exclusive([0], [3], pools)
            assert ei.value.pools is pools
            c.make_positions_exclusive([0], [3], pools)   # the copy runs now
        _same_books(j, t)


# -- block_multihead_attention -------------------------------------------------

def _dense_attention(q, k, v):
    """tests/test_paged_kv.py's oracle: one query row (heads, D) over keys
    (T, kv, D), GQA by head groups, fp64."""
    n_q, n_kv = q.shape[0], k.shape[1]
    g = n_q // n_kv
    out = np.zeros_like(q, dtype=np.float64)
    for h in range(n_q):
        s = k[:, h // g].astype(np.float64) @ q[h].astype(np.float64) / np.sqrt(q.shape[1])
        w = np.exp(s - s.max())
        out[h] = (w / w.sum()) @ v[:, h // g].astype(np.float64)
    return out


def _bmha_setup(B, n_kv, D, bs, max_blocks):
    nb = 1 + B * max_blocks
    tables = np.arange(1, nb).reshape(B, max_blocks).astype(np.int64)
    return np.zeros((nb, n_kv, bs, D), np.float32), tables


@pytest.mark.parametrize("n_q,n_kv,enc,bias", [
    (4, 2, (5, 3), False), (4, 4, (7, 1, 4), True), (8, 1, (12, 9), False),
], ids=["gqa", "mha_bias", "mqa_multiblock"])
def test_block_multihead_attention_prefill_then_decode(n_q, n_kv, enc, bias):
    B, D, bs, max_blocks = len(enc), 8, 4, 4
    kc0, tables = _bmha_setup(B, n_kv, D, bs, max_blocks)
    rng = np.random.RandomState(sum(enc))
    enc = np.asarray(enc, np.int32)
    width = (n_q + 2 * n_kv) * D
    qkv = rng.randn(int(enc.sum()), width).astype(np.float32)
    qkv_bias = rng.randn(width).astype(np.float32) * 0.1 if bias else None
    zeros = np.zeros(B, np.int32)
    j_out, j_qkv, jkc, jvc = JF.block_multihead_attention(
        paddle.to_tensor(qkv), paddle.to_tensor(kc0), paddle.to_tensor(kc0),
        paddle.to_tensor(enc), paddle.to_tensor(zeros), paddle.to_tensor(enc),
        block_tables=paddle.to_tensor(tables), block_size=bs,
        qkv_bias=None if qkv_bias is None else paddle.to_tensor(qkv_bias))
    tkc, tvc = torch.from_numpy(kc0.copy()), torch.from_numpy(kc0.copy())
    t_out, t_qkv, tkc2, tvc2 = TF.block_multihead_attention(
        torch.from_numpy(qkv), tkc, tvc, torch.from_numpy(enc), torch.from_numpy(zeros),
        torch.from_numpy(enc), block_tables=torch.from_numpy(tables), block_size=bs,
        qkv_bias=None if qkv_bias is None else torch.from_numpy(qkv_bias))
    assert tkc2 is tkc and tvc2 is tvc           # written in place
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out.value), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(t_qkv.numpy(), np.asarray(j_qkv.value))
    np.testing.assert_array_equal(tkc.numpy(), np.asarray(jkc.value))
    np.testing.assert_array_equal(tvc.numpy(), np.asarray(jvc.value))
    biased = qkv + (0 if qkv_bias is None else qkv_bias)
    row = 0
    for b in range(B):
        L = int(enc[b])
        rows = biased[row:row + L].reshape(L, n_q + 2 * n_kv, D)
        for t in range(L):
            want = _dense_attention(rows[t, :n_q], rows[:t + 1, n_q:n_q + n_kv],
                                    rows[:t + 1, n_q + n_kv:])
            np.testing.assert_allclose(t_out[row + t].numpy().reshape(n_q, D), want,
                                       rtol=1e-5, atol=1e-5)
        row += L
    # one decode step a sequence against the written history
    q1 = rng.randn(B, width).astype(np.float32)
    ones = np.ones(B, np.int32)
    j_out2, _, jkc3, _ = JF.block_multihead_attention(
        paddle.to_tensor(q1), jkc, jvc, paddle.to_tensor(zeros), paddle.to_tensor(enc),
        paddle.to_tensor(ones), block_tables=paddle.to_tensor(tables), block_size=bs,
        qkv_bias=None if qkv_bias is None else paddle.to_tensor(qkv_bias))
    t_out2, _, _, _ = TF.block_multihead_attention(
        torch.from_numpy(q1), tkc, tvc, torch.from_numpy(zeros), torch.from_numpy(enc),
        torch.from_numpy(ones), block_tables=torch.from_numpy(tables), block_size=bs,
        qkv_bias=None if qkv_bias is None else torch.from_numpy(qkv_bias))
    np.testing.assert_allclose(t_out2.numpy(), np.asarray(j_out2.value), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(tkc.numpy(), np.asarray(jkc3.value))
    q1b = q1 + (0 if qkv_bias is None else qkv_bias)
    row = 0
    for b in range(B):
        L = int(enc[b])
        rows = biased[row:row + L].reshape(L, n_q + 2 * n_kv, D)
        new = q1b[b].reshape(n_q + 2 * n_kv, D)
        ks = np.concatenate([rows[:, n_q:n_q + n_kv], new[None, n_q:n_q + n_kv]])
        vs = np.concatenate([rows[:, n_q + n_kv:], new[None, n_q + n_kv:]])
        np.testing.assert_allclose(t_out2[b].numpy().reshape(n_q, D),
                                   _dense_attention(new[:n_q], ks, vs), rtol=1e-5, atol=1e-5)
        row += L


def test_block_multihead_attention_max_enc_len_gives_the_same_result():
    """``max_enc_len_this_time`` (the reference's host value) sets the padded
    length; the result is the one the lengths give."""
    kc0, tables = _bmha_setup(2, 2, 8, 4, 3)
    enc = np.array([5, 3], np.int32)
    qkv = torch.from_numpy(np.random.RandomState(4).randn(8, 64).astype(np.float32))
    outs = []
    for max_enc in (None, torch.tensor([5], dtype=torch.int32)):
        out, *_ = TF.block_multihead_attention(
            qkv, torch.from_numpy(kc0.copy()), torch.from_numpy(kc0.copy()), enc,
            np.zeros(2, np.int32), enc, block_tables=tables, max_enc_len_this_time=max_enc)
        outs.append(out)
    np.testing.assert_allclose(outs[0].numpy(), outs[1].numpy(), rtol=1e-6, atol=1e-6)


def _bmha_call(mod, to, **kw):
    kc0, tables = _bmha_setup(2, 2, 8, 4, 3)
    args = dict(qkv=np.zeros((2, 64), np.float32), key_cache=kc0, value_cache=kc0.copy(),
                seq_lens_encoder=np.zeros(2, np.int32), seq_lens_decoder=np.ones(2, np.int32),
                seq_lens_this_time=np.ones(2, np.int32), block_tables=tables)
    args.update(kw)
    return mod.block_multihead_attention(**{k: (None if v is None else to(v))
                                            for k, v in args.items()})


@pytest.mark.parametrize("kw,exc,match", [
    (dict(cache_k_quant_scales=np.ones(2, np.float32)), NotImplementedError, "cache_k_quant"),
    (dict(rope_emb=np.ones(2, np.float32)), NotImplementedError, "rope_emb"),
    (dict(mask=np.ones(2, np.float32)), NotImplementedError, "mask"),
    (dict(out_scale=2), NotImplementedError, "quantization"),
    (dict(block_tables=None), ValueError, "block_tables"),
    (dict(seq_lens_encoder=np.array([3, 0], np.int32),
          qkv=np.zeros((3, 64), np.float32)), NotImplementedError, "mixed prefill"),
    (dict(seq_lens_encoder=np.array([3, 2], np.int32), seq_lens_decoder=np.zeros(2, np.int32),
          seq_lens_this_time=np.array([2, 2], np.int32), qkv=np.zeros((4, 64), np.float32)),
     NotImplementedError, "chunked prefill"),
    (dict(seq_lens_this_time=np.array([1, 2], np.int32)), NotImplementedError, "one token"),
], ids=["quant", "rope", "mask", "out_scale", "no_tables", "mixed", "chunked", "decode_two"])
def test_block_multihead_attention_rejects_as_jax(kw, exc, match):
    def jax_to(v):
        return v if np.isscalar(v) else paddle.to_tensor(v)

    def torch_to(v):
        return v if np.isscalar(v) else torch.from_numpy(np.asarray(v))

    for mod, to in ((JF, jax_to), (TF, torch_to)):
        with pytest.raises(exc, match=match):
            _bmha_call(mod, to, **kw)


@pytest.mark.parametrize("phase", ["prefill", "decode"])
def test_block_multihead_attention_bounds_checked(phase):
    """Positions past the block tables raise (the JAX function writes past
    the table silently)."""
    kc0, tables = _bmha_setup(2, 2, 8, 4, 3)                 # 12 positions a row
    if phase == "prefill":
        enc = np.array([13, 1], np.int32)
        args = (np.zeros((14, 64), np.float32), enc, np.zeros(2, np.int32), enc)
    else:
        args = (np.zeros((2, 64), np.float32), np.zeros(2, np.int32),
                np.array([12, 3], np.int32), np.ones(2, np.int32))
    qkv, e, d, n = (torch.from_numpy(a) for a in args)
    with pytest.raises(ValueError, match="block table"):
        TF.block_multihead_attention(qkv, torch.from_numpy(kc0), torch.from_numpy(kc0.copy()),
                                     e, d, n, block_tables=tables)


@pytest.mark.parametrize("kw,exc,match", [
    (dict(seq_lens_encoder=np.array([3, 0], np.int32),
          qkv=np.zeros((3, 64), np.float32)), NotImplementedError, "mixed prefill"),
    (dict(seq_lens_encoder=np.array([3, 2], np.int32), seq_lens_decoder=np.zeros(2, np.int32),
          seq_lens_this_time=np.array([2, 2], np.int32), qkv=np.zeros((4, 64), np.float32)),
     NotImplementedError, "chunked prefill"),
    (dict(seq_lens_this_time=np.array([1, 2], np.int32)), NotImplementedError, "one token"),
    (dict(seq_lens_decoder=np.array([12, 3], np.int32)), ValueError, "block table"),
], ids=["mixed", "chunked", "decode_two", "decode_past_table"])
def test_block_multihead_attention_checks_host_lengths_on_the_host(kw, exc, match,
                                                                   monkeypatch):
    """Host lengths (numpy here) are checked before anything reaches the
    device: with qkv and the caches on the ``meta`` device the call raises the
    JAX type, and no device assert is made (on the card a failed device
    assert ends the process's CUDA context)."""
    asserts = []
    monkeypatch.setattr(torch, "_assert_async", lambda *a: asserts.append(a))
    kc0, tables = _bmha_setup(2, 2, 8, 4, 3)
    args = dict(qkv=np.zeros((2, 64), np.float32), seq_lens_encoder=np.zeros(2, np.int32),
                seq_lens_decoder=np.ones(2, np.int32), seq_lens_this_time=np.ones(2, np.int32))
    args.update(kw)
    qkv = torch.empty(args.pop("qkv").shape, device="meta")
    kc = torch.empty(kc0.shape, device="meta")
    with pytest.raises(exc, match=match):
        TF.block_multihead_attention(qkv, kc, torch.empty_like(kc), block_tables=tables,
                                     **args)
    assert asserts == []
