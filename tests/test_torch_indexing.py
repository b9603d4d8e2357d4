"""paddle's getitem and setitem_ in the port (``ops/indexing.py``) against the
JAX package's (``paddle_tpu/ops/indexing.py``), on the same numpy inputs:
values and dtypes exactly (indexing moves values, it computes nothing), and
the gradients of ``sum(out * ct)`` to float32 op_test tolerance (rtol 1e-5 /
atol 1e-6; scatter-adds of repeated indices sum in either order).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as T
from paddle_tpu.ops import indexing as jindexing
from paddle_tpu_torch.device import _CURRENT


@pytest.fixture(autouse=True)
def _on_cpu():
    before = _CURRENT[0]
    T.set_device("cpu")
    yield
    _CURRENT[0] = before


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().numpy()
    return np.asarray(t.numpy())


def _getitem(P):
    return jindexing.getitem if P is paddle else T.getitem


def _setitem(P):
    return jindexing.setitem_ if P is paddle else T.setitem_


X = np.random.RandomState(0).standard_normal((4, 5, 3)).astype(np.float32)
MASK2 = np.random.RandomState(1).rand(4, 5) > 0.5
MASK3 = np.random.RandomState(2).rand(4, 5, 3) > 0.5


def I(P, a):  # noqa: E743  (an index tensor)
    return P.to_tensor(np.asarray(a), place="cpu")


INDICES = [
    ("int", lambda P: 2),
    ("negative_int", lambda P: -1),
    ("slice", lambda P: slice(1, 3)),
    ("slice_step", lambda P: (slice(None), slice(0, 5, 2))),
    ("negative_step", lambda P: (slice(None, None, -1), slice(4, 0, -2))),
    ("negative_step_after_ellipsis", lambda P: (Ellipsis, slice(None, None, -2))),
    ("none", lambda P: (None, 1, None)),
    ("ellipsis", lambda P: (Ellipsis, 0)),
    ("ellipsis_middle", lambda P: (1, Ellipsis, slice(0, 2))),
    ("int_list", lambda P: [0, 2, 2]),
    ("int_tensor", lambda P: I(P, [3, 1])),
    ("int_tensor_2d", lambda P: I(P, [[0, 1], [2, 3]])),
    ("zero_d_tensor", lambda P: I(P, np.int64(2))),
    ("ndarray", lambda P: np.array([1, 0])),
    ("bool_list", lambda P: [True, False, True, False]),
    ("bool_1d", lambda P: I(P, np.array([False, True, True, False]))),
    ("bool_2d", lambda P: I(P, MASK2)),
    ("bool_full", lambda P: I(P, MASK3)),
    ("advanced_and_slice", lambda P: (I(P, [0, 3]), slice(1, 4))),
    ("two_advanced_split", lambda P: (I(P, [0, 3]), slice(None), I(P, [2, 0]))),
    ("two_advanced_adjacent", lambda P: (slice(None), I(P, [0, 4, 1]), I(P, [2, 0, 1]))),
    ("int_and_list", lambda P: (1, [0, 3])),
]


@pytest.mark.parametrize("name,index", INDICES, ids=[i[0] for i in INDICES])
def test_getitem_matches_jax(name, index):
    outs, grads = [], []
    for P in (paddle, T):
        x = P.to_tensor(X, place="cpu", stop_gradient=False)
        y = _getitem(P)(x, index(P))
        ct = np.random.RandomState(3).standard_normal(_np(y).shape).astype(np.float32)
        P.sum(P.multiply(y, P.to_tensor(ct, place="cpu"))).backward()
        outs.append(_np(y))
        grads.append(_np(x.grad))
    assert outs[1].shape == outs[0].shape and outs[1].dtype == outs[0].dtype
    np.testing.assert_array_equal(outs[1], outs[0])
    np.testing.assert_allclose(grads[1], grads[0], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("P", [paddle, T], ids=["jax", "torch"])
def test_mixed_boolean_raises(P):
    x = P.to_tensor(X, place="cpu")
    with pytest.raises(NotImplementedError):
        _getitem(P)(x, (I(P, MASK2), 0))


def test_getitem_is_one_op_for_strided_slice_and_crop():
    from paddle_tpu_torch.ops import _apply
    from paddle_tpu_torch.ops import indexing, manipulation

    assert manipulation._getitem is indexing._getitem
    assert _apply.get_registry()["getitem"] is indexing._getitem.opdef


SETS = [
    ("int_scalar", lambda P: 1, 7.0),
    ("slice_tensor", lambda P: (slice(0, 2), 1), "value"),
    ("negative_index", lambda P: -1, 0.5),
    ("int_tensor_tensor", lambda P: I(P, [0, 2]), "value"),
    ("bool_full_scalar", lambda P: I(P, MASK3), -1.0),
    ("bool_full_tensor", lambda P: I(P, MASK3), "full"),
    ("bool_1d_tensor", lambda P: I(P, np.array([True, False, False, True])), "value"),
    ("ellipsis", lambda P: (Ellipsis, 2), "value"),
]


def _value(P, kind, x, idx):
    if kind == "value":
        shape = _np(_getitem(P)(x, idx)).shape
        v = np.random.RandomState(4).standard_normal(shape).astype(np.float32)
        return P.to_tensor(v, place="cpu", stop_gradient=False)
    if kind == "full":
        v = np.random.RandomState(5).standard_normal(X.shape).astype(np.float32)
        return P.to_tensor(v, place="cpu", stop_gradient=False)
    return kind


@pytest.mark.parametrize("name,index,kind", SETS, ids=[s[0] for s in SETS])
def test_setitem_on_a_non_leaf_matches_jax(name, index, kind):
    """The write lands in place, and the gradient reaches the value and the
    cells of the old tensor that were not written."""
    results = []
    for P in (paddle, T):
        w = P.to_tensor(X, place="cpu", stop_gradient=False)
        x = P.multiply(w, P.to_tensor(np.float32(2.0), place="cpu"))
        idx = index(P)
        v = _value(P, kind, x, idx)
        same = _setitem(P)(x, idx, v)
        assert same is x
        ct = np.random.RandomState(6).standard_normal(X.shape).astype(np.float32)
        P.sum(P.multiply(P.exp(x), P.to_tensor(ct, place="cpu"))).backward()
        results.append([_np(x), _np(w.grad)] + (
            [_np(v.grad)] if not isinstance(v, float) else []))
    for t, j in zip(results[1], results[0]):
        np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-6)


def test_setitem_without_grad_writes_in_place_and_casts():
    for P in (paddle, T):
        x = P.to_tensor(np.zeros((2, 3), np.float32), place="cpu")
        _setitem(P)(x, (0, slice(None)), P.to_tensor(np.array([1, 2, 3], np.int64),
                                                     place="cpu"))
        _setitem(P)(x, (1, 2), 9)
        assert str(x.dtype).endswith("float32")
        np.testing.assert_array_equal(_np(x), [[1, 2, 3], [0, 0, 9]])


def test_setitem_on_a_leaf_that_requires_grad():
    """Known difference: the JAX package swaps a leaf's value under its tape;
    torch cannot write a leaf that requires grad in place, so the port
    raises, as ``reshape_`` does."""
    j = paddle.to_tensor(X, stop_gradient=False)
    jindexing.setitem_(j, 0, 1.0)
    np.testing.assert_array_equal(_np(j)[0], 1.0)
    t = T.to_tensor(X, stop_gradient=False)
    with pytest.raises(RuntimeError, match="leaf"):
        T.setitem_(t, 0, 1.0)
    np.testing.assert_array_equal(_np(t), X)
