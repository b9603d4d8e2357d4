"""The port's GPT and BERT/ERNIE families (paddle_tpu_torch/models/gpt.py,
bert.py) against the JAX package's.

Each model is built in both packages and the JAX ``state_dict`` carried
into the port's with ``set_state_dict`` (no transpose; the keys and their
order equal). Dropout draws from each package's own generator, so the
comparisons run in eval mode, or in training mode with every dropout
probability at 0.

GPT (2 layers, 64 wide, 4 heads), tied and untied, at S 16 and S 160 (the
attention above 128 query rows, though the CPU takes the plain path): eval
logits, the training loss and every gradient by ``state_dict`` key (rtol
2e-4 / atol 2e-5, tests/test_models.py's bound for GPT gradients), then
three AdamW steps (losses 1e-5, parameters 1e-5; the elements whose first
gradient is float32 noise around 0, such as the key projection's bias,
within AdamW's step bound);
``fused_head_ce`` equals the standard loss and gradients and JAX's fused
loss; tensor/sequence/pipeline parallelism and ``recompute_policy`` raise;
with hidden dropout 0.1, ``recompute=True`` gives the gradients of
``recompute=False`` for one seed (the recompute replays the RNG state).

BERT/ERNIE: ``BertForPretraining`` with ``BertPretrainingCriterion`` (MLM
labels with -100, NSP labels), token types, a 2-D padding mask and ERNIE's
task types: outputs, loss and every gradient, three AdamW steps; the
``state_dict`` has JAX's 30 keys at one layer in JAX's order, without the
tied decoder weight, which is one tensor with the word embeddings; a JAX
``state_dict`` loads into the port and the port's back into JAX;
tests/test_models.py's TestGPT and TestBert cases on the port.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as T
from paddle_tpu.models import bert as JB
from paddle_tpu.models import gpt as JG
from paddle_tpu_torch.models import bert as TB
from paddle_tpu_torch.models import gpt as TG
from test_torch_nn_layers import _sd
from test_torch_ops import _np, _on_cpu  # noqa: F401

GRAD_RTOL, GRAD_ATOL = 2e-4, 2e-5
LR = 1e-3
# a first gradient below this is float32 noise around 0 (the mean magnitude is
# ~2e-3): AdamW may step such an element either way (``_compare_after_adamw``)
GRAD_NOISE = 1e-6


def _carry(jm, tm):
    missing, unexpected = tm.set_state_dict(_sd(jm))
    assert missing == [] and unexpected == []
    assert list(tm.state_dict()) == list(jm.state_dict())


def _grads(model):
    return {n: _np(p.grad) for n, p in model.named_parameters() if p.grad is not None}


def _compare_grads(tm, jm):
    jg, tg = _grads(jm), _grads(tm)
    assert list(tg) == list(jg)
    for k in jg:
        np.testing.assert_allclose(tg[k], jg[k], rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=k)


def _compare_after_adamw(tm, jm, start, first_grads):
    """The parameters after the AdamW steps, at 1e-5 but for the elements
    whose first gradient is float32 noise (below ``GRAD_NOISE``), such as a
    key bias, which shifts every logit of a row alike and so has a gradient
    of 0 up to rounding: AdamW's normalised step turns that noise into steps
    of up to lr in either package, so those move at most 3 lr from the start
    in each."""
    for k, v in _sd(jm).items():
        t = _sd(tm)[k]
        noise = np.abs(first_grads[k]) < GRAD_NOISE
        for sd in (t, v):
            assert np.abs(sd - start[k])[noise].max(initial=0) <= 3 * LR * 1.01, k
        np.testing.assert_allclose(t[~noise], v[~noise], rtol=1e-5, atol=1e-5, err_msg=k)


def _adamw_curves(pairs, batch_loss):
    """Three AdamW steps of each (package, model): the losses, and the JAX
    model's first gradients."""
    curves, first = [], None
    for P, m in pairs:
        m.train()
        opt = P.optimizer.AdamW(learning_rate=LR, parameters=m.parameters(), weight_decay=0.01)
        curve = []
        for step in range(3):
            loss = batch_loss(P, m, step)
            loss.backward()
            if step == 0 and P is paddle:
                first = _grads(m)
            opt.step()
            opt.clear_grad()
            curve.append(float(_np(loss)))
        curves.append(curve)
    np.testing.assert_allclose(curves[1], curves[0], rtol=1e-5, atol=1e-5)
    return first


# -- GPT -----------------------------------------------------------------------
def _gpt_kw(**kw):
    base = dict(vocab_size=96, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                max_position_embeddings=192, hidden_dropout_prob=0.0,
                attention_probs_dropout_prob=0.0)
    base.update(kw)
    return base


def _gpt_pair(seed=0, **kw):
    paddle.seed(seed)
    jm = JG.GPTForCausalLM(JG.GPTConfig(**_gpt_kw(**kw)))
    tm = TG.GPTForCausalLM(TG.GPTConfig(**_gpt_kw(**kw)))
    _carry(jm, tm)
    return jm, tm


def _gpt_data(S, seed=1, B=2, vocab=96):
    r = np.random.RandomState(seed)
    labels = r.randint(0, vocab, (B, S))
    labels[0, :3] = -100
    return r.randint(0, vocab, (B, S)), labels


GPT_CASES = [pytest.param(tied, S, id=f"{'tied' if tied else 'untied'}_s{S}")
             for tied in (True, False) for S in (16, 160)]


@pytest.mark.parametrize("tied,S", GPT_CASES)
def test_gpt_forward_loss_and_gradients_match_jax(tied, S):
    jm, tm = _gpt_pair(tie_word_embeddings=tied)
    ids, labels = _gpt_data(S)
    jm.eval()
    tm.eval()
    np.testing.assert_allclose(_np(tm(torch.tensor(ids))), _np(jm(paddle.to_tensor(ids))),
                               rtol=1e-5, atol=1e-5)
    jm.train()
    tm.train()
    jl, jlog = jm(paddle.to_tensor(ids), labels=paddle.to_tensor(labels))
    tl, tlog = tm(torch.tensor(ids), labels=torch.tensor(labels))
    np.testing.assert_allclose(float(_np(tl)), float(_np(jl)), rtol=1e-5)
    assert tuple(tlog.shape) == (2, S, 96)
    jl.backward()
    tl.backward()
    _compare_grads(tm, jm)
    assert len(_grads(tm)) == len(_sd(tm))


@pytest.mark.parametrize("tied", [True, False], ids=["tied", "untied"])
def test_gpt_three_adamw_steps_match_jax(tied):
    jm, tm = _gpt_pair(seed=2, tie_word_embeddings=tied)
    start = _sd(jm)

    def batch_loss(P, m, step):
        ids, labels = _gpt_data(16, seed=10 + step)
        return m(P.to_tensor(ids, place="cpu"), labels=P.to_tensor(labels, place="cpu"))[0]

    first = _adamw_curves(((paddle, jm), (T, tm)), batch_loss)
    _compare_after_adamw(tm, jm, start, first)


@pytest.mark.parametrize("tied", [True, False], ids=["tied", "untied"])
def test_gpt_fused_head_ce_matches_standard(tied):
    """tests/test_models.py test_gpt_fused_head_ce_matches_standard on the
    port, and the fused loss against JAX's."""
    kw = dict(vocab_size=96, hidden_size=48, num_hidden_layers=2, num_attention_heads=4,
              max_position_embeddings=32, hidden_dropout_prob=0.0,
              attention_probs_dropout_prob=0.0, tie_word_embeddings=tied)
    T.seed(11)
    m_std = TG.GPTForCausalLM(TG.GPTConfig(**kw))
    m_fused = TG.GPTForCausalLM(TG.GPTConfig(fused_head_ce=True, **kw))
    m_fused.set_state_dict(_sd(m_std))
    paddle.seed(11)
    j_fused = JG.GPTForCausalLM(JG.GPTConfig(fused_head_ce=True, **kw))
    j_fused.set_state_dict(_sd(m_std))
    r = np.random.RandomState(4)
    ids, labels = r.randint(0, 96, (2, 17)), r.randint(0, 96, (2, 17))
    loss_s, logits = m_std(torch.tensor(ids), labels=torch.tensor(labels))
    loss_f, none_logits = m_fused(torch.tensor(ids), labels=torch.tensor(labels)[..., None])
    assert logits is not None and none_logits is None
    np.testing.assert_allclose(float(loss_s), float(loss_f), rtol=1e-5, atol=1e-6)
    jl, _ = j_fused(paddle.to_tensor(ids), labels=paddle.to_tensor(labels))
    np.testing.assert_allclose(float(loss_f), float(_np(jl)), rtol=1e-5, atol=1e-6)
    loss_s.backward()
    loss_f.backward()
    for (n1, p1), (_, p2) in zip(m_std.named_parameters(), m_fused.named_parameters()):
        np.testing.assert_allclose(_np(p1.grad), _np(p2.grad), rtol=2e-4, atol=2e-5,
                                   err_msg=f"{n1} (tied={tied})")


@pytest.mark.parametrize("kw", [dict(tensor_parallel_degree=2), dict(sequence_parallel=True),
                                dict(pipeline_parallel_degree=2),
                                dict(recompute_policy="budget")],
                         ids=["tp", "sp", "pp", "recompute_policy"])
def test_gpt_parallel_options_raise(kw):
    with pytest.raises(NotImplementedError, match="Queue A item 10"):
        TG.GPTForCausalLM(TG.GPTConfig(**_gpt_kw(**kw)))


def test_gpt_recompute_replays_the_dropout_masks():
    """Port only: hidden dropout 0.1, one seed, the same gradients with and
    without recompute."""
    grads = []
    for recompute in (False, True):
        T.seed(5)
        m = TG.GPTForCausalLM(TG.GPTConfig(**_gpt_kw(hidden_dropout_prob=0.1,
                                                      recompute=recompute)))
        m.train()
        ids, labels = _gpt_data(16)
        T.seed(6)
        loss, _ = m(torch.tensor(ids), labels=torch.tensor(labels))
        loss.backward()
        grads.append((float(loss), _grads(m)))
    (l0, g0), (l1, g1) = grads
    assert l0 == l1
    assert list(g0) == list(g1)
    for k in g0:
        np.testing.assert_allclose(g1[k], g0[k], rtol=1e-6, atol=1e-7, err_msg=k)


class TestGPT:
    """tests/test_models.py TestGPT on the port."""

    def test_forward_backward(self):
        T.seed(0)
        m = TG.GPTForCausalLM(TG.GPTConfig(vocab_size=128, hidden_size=64,
                                           num_hidden_layers=2, num_attention_heads=4,
                                           max_position_embeddings=64))
        ids, labels = _gpt_data(16, B=4, vocab=128)
        loss, logits = m(torch.tensor(ids), labels=torch.tensor(labels))
        assert tuple(logits.shape) == (4, 16, 128)
        loss.backward()
        assert m.gpt.embeddings.word_embeddings.weight.grad is not None

    def test_eval_deterministic(self):
        T.seed(0)
        m = TG.GPTForCausalLM(TG.GPTConfig(vocab_size=128, hidden_size=64,
                                           num_hidden_layers=1, num_attention_heads=4,
                                           max_position_embeddings=64,
                                           hidden_dropout_prob=0.5,
                                           attention_probs_dropout_prob=0.5))
        m.eval()
        ids, _ = _gpt_data(16, B=4, vocab=128)
        np.testing.assert_array_equal(_np(m(torch.tensor(ids))), _np(m(torch.tensor(ids))))

    def test_all_ignored_labels_give_zero(self):
        _, m = _gpt_pair()
        ids, _ = _gpt_data(8)
        loss, _ = m(torch.tensor(ids), labels=torch.full((2, 8), -100))
        assert float(loss) == 0.0


# -- BERT / ERNIE ----------------------------------------------------------------
def _bert_kw(**kw):
    base = dict(vocab_size=96, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
                intermediate_size=64, max_position_embeddings=16, hidden_dropout_prob=0.0,
                attention_probs_dropout_prob=0.0)
    base.update(kw)
    return base


def _bert_pair(ernie=False, seed=0, **kw):
    paddle.seed(seed)
    if ernie:
        jm, tm = JB.ErnieForPretraining(**_bert_kw(**kw)), TB.ErnieForPretraining(
            **_bert_kw(**kw))
    else:
        jm = JB.BertForPretraining(JB.BertConfig(**_bert_kw(**kw)))
        tm = TB.BertForPretraining(TB.BertConfig(**_bert_kw(**kw)))
    _carry(jm, tm)
    return jm, tm


def _bert_batch(seed=0, B=4, S=8, vocab=96):
    r = np.random.RandomState(seed)
    ids = r.randint(0, vocab, (B, S))
    labels = r.randint(0, vocab, (B, S))
    labels[:, ::2] = -100
    nsp = r.randint(0, 2, B)
    types = r.randint(0, 2, (B, S))
    mask = np.ones((B, S), np.int64)
    mask[1::2, S - 3:] = 0
    tasks = r.randint(0, 3, (B, S))
    return ids, labels, nsp, types, mask, tasks


def _bert_loss(P, m, vocab, batch, with_types, with_mask, with_tasks, nsp_on=True):
    ids, labels, nsp, types, mask, tasks = (P.to_tensor(a, place="cpu") for a in batch)
    kw = {}
    if with_types:
        kw["token_type_ids"] = types
    if with_mask:
        kw["attention_mask"] = mask
    if with_tasks:
        kw["task_type_ids"] = tasks
    scores, rel = m(ids, **kw)
    crit = (JB if P is paddle else TB).BertPretrainingCriterion(vocab)
    return scores, rel, crit(scores, rel, labels, nsp if nsp_on else None)


BERT_CASES = [
    pytest.param(False, False, False, False, True, id="bert_plain"),
    pytest.param(False, True, True, False, True, id="bert_types_mask"),
    pytest.param(False, True, False, False, False, id="bert_mlm_only"),
    pytest.param(True, True, True, True, True, id="ernie_tasks_mask"),
]


@pytest.mark.parametrize("ernie,types,mask,tasks,nsp", BERT_CASES)
def test_bert_outputs_loss_and_gradients_match_jax(ernie, types, mask, tasks, nsp):
    jm, tm = _bert_pair(ernie)
    batch = _bert_batch()
    got = []
    for P, m in ((paddle, jm), (T, tm)):
        m.train()
        scores, rel, loss = _bert_loss(P, m, 96, batch, types, mask, tasks, nsp)
        loss.backward()
        got.append((_np(scores), _np(rel), float(_np(loss))))
    for a, b in zip(got[1], got[0]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    _compare_grads(tm, jm)
    # without NSP labels the pooler and the classifier have no gradient, in
    # either package
    assert len(_grads(tm)) == len(_sd(tm)) - (0 if nsp else 4)


def test_bert_three_adamw_steps_match_jax():
    jm, tm = _bert_pair(seed=3)
    start = _sd(jm)

    def batch_loss(P, m, step):
        return _bert_loss(P, m, 96, _bert_batch(seed=20 + step), True, True, False)[2]

    first = _adamw_curves(((paddle, jm), (T, tm)), batch_loss)
    _compare_after_adamw(tm, jm, start, first)


def test_bert_state_dict_keys_and_the_tie():
    paddle.seed(0)
    jm = JB.BertForPretraining(JB.BertConfig(**_bert_kw(num_hidden_layers=1)))
    tm = TB.BertForPretraining(TB.BertConfig(**_bert_kw(num_hidden_layers=1)))
    keys = list(tm.state_dict())
    assert keys == list(jm.state_dict()) and len(keys) == 30
    assert not any("decoder_weight" in k for k in keys)
    assert [n for n, _ in tm.named_parameters()] == [n for n, _ in jm.named_parameters()]
    assert tm.cls.decoder_weight is tm.bert.embeddings.word_embeddings.weight
    # the JAX state loads into the port, the port's back into JAX
    _carry(jm, tm)
    with torch.no_grad():
        for p in tm.parameters():
            p.mul_(1.5)
    missing, unexpected = jm.set_state_dict(_sd(tm))
    assert not missing and not unexpected
    for k, v in _sd(tm).items():
        np.testing.assert_array_equal(_sd(jm)[k], v)
    np.testing.assert_array_equal(_np(tm.cls.decoder_weight),
                                  _np(jm.cls.decoder_weight))
    # one tensor after a move and a copy too
    moved = tm.to(dtype="float64")
    assert moved.cls.decoder_weight is moved.bert.embeddings.word_embeddings.weight
    import copy

    twin = copy.deepcopy(tm)
    assert twin.cls.decoder_weight is twin.bert.embeddings.word_embeddings.weight
    assert twin.cls.decoder_weight is not tm.cls.decoder_weight


def test_bert_parallel_options_raise():
    for kw in (dict(tensor_parallel_degree=2), dict(sequence_parallel=True)):
        with pytest.raises(NotImplementedError, match="Queue A item 10"):
            TB.BertForPretraining(TB.BertConfig(**_bert_kw(**kw)))


class TestBert:
    """tests/test_models.py TestBert on the port."""

    def test_pretraining_loss_decreases(self):
        T.seed(0)
        cfg = TB.BertConfig(**_bert_kw())
        model = TB.BertForPretraining(cfg)
        crit = TB.BertPretrainingCriterion(cfg.vocab_size)
        opt = T.optimizer.AdamW(learning_rate=3e-3, parameters=model.parameters())
        ids, labels, nsp = (torch.tensor(a) for a in _bert_batch()[:3])
        losses = []
        for _ in range(30):
            logits, rel = model(ids)
            loss = crit(logits, rel, labels, nsp)
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(float(loss))
        assert losses[-1] < 0.7 * losses[0], losses

    def test_padding_mask_changes_output(self):
        T.seed(1)
        model = TB.BertForPretraining(TB.BertConfig(**_bert_kw()))
        model.eval()
        ids = torch.tensor(_bert_batch()[0])
        full = torch.ones(4, 8, dtype=torch.int64)
        part = full.clone()
        part[:, 6:] = 0
        out_full, _ = model(ids, attention_mask=full)
        out_part, _ = model(ids, attention_mask=part)
        assert not np.allclose(_np(out_full)[:, :6], _np(out_part)[:, :6])

    def test_ernie_task_embeddings(self):
        T.seed(2)
        model = TB.ErnieForPretraining(vocab_size=64, hidden_size=16, num_hidden_layers=1,
                                       num_attention_heads=2, intermediate_size=32,
                                       max_position_embeddings=16, hidden_dropout_prob=0.0,
                                       attention_probs_dropout_prob=0.0)
        model.eval()
        ids = torch.arange(8).reshape(1, 8)
        out0, _ = model(ids, task_type_ids=torch.zeros(1, 8, dtype=torch.int64))
        out1, _ = model(ids, task_type_ids=torch.ones(1, 8, dtype=torch.int64))
        assert not np.allclose(_np(out0), _np(out1))
        assert isinstance(model.bert.config, TB.ErnieConfig)
        assert TB.ErnieModel(vocab_size=64, hidden_size=16, num_hidden_layers=1,
                             num_attention_heads=2, intermediate_size=32).config \
            .task_type_vocab_size == 3
