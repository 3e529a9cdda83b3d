"""The decode's distributed softmax on one process.

A rank of a mesh whose decode cache is sharded over its sequence attends
only its own keys (``attention.decode_partials``: the row max of the
allowed scores, the sum of their exponentials and the unnormalised
output), and the ranks' partials are combined by log-sum-exp. Here a
key window is cut in 2 and 4 parts and the parts' partials merged
(``attention.merge_partials``, the same rescaling and normalisation the
ranks run around their all-reduces): the result is attention over the
whole window (``gqa_attention``) within 1e-6, and within 1e-12 of the
softmax computed in fp64, with a softcap and per-row ``valid_len``,
where a part holds no allowed key for some rows or for all of them (its
max -inf, its weight 0, no NaN). A row with no allowed key at all comes
out 0, the port's convention for such a row. The four-rank runs of the
same code are ``tests/test_torch_sharded_step.py``'s decode cases.
"""
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.models.layers import attention as attn  # noqa: E402
from repro_torch.sharding import dtensor as sdt  # noqa: E402

B, K, G, DH, T, WINDOW = 3, 2, 2, 8, 32, 10
# each row's query position: with the window of 10 and valid_len = pos + 1
# row 0 sees keys 13..22, row 1 3..12, row 2 11..20, so keys 24..31 (the
# last of 4 parts) are masked for every row, and 16..31 for row 1
POS = (22, 12, 20)


def inputs(seed=0):
    gen = torch.Generator().manual_seed(seed)

    def draw(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=gen, dtype=torch.float64)
    return (draw(B, 1, K, G, DH, scale=3.0), draw(B, T, K, DH),
            draw(B, T, K, DH))


def fp64_attention(q, k, v, q_pos, valid, softcap):
    """The masked softmax of the capped scores, all in fp64."""
    s = torch.einsum("bqkgd,btkd->bqkgt", q, k) / math.sqrt(DH)
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    kp = torch.arange(T)[None, None, :]
    qp = q_pos[:, :, None]
    ok = (kp <= qp) & (kp > qp - WINDOW) & (kp < valid)
    s = s.masked_fill(~ok[:, :, None, None], -math.inf)
    return torch.einsum("bqkgt,btkd->bqkgd", torch.softmax(s, -1), v)


def split(q, k, v, q_pos, valid, parts, softcap):
    w = T // parts
    k_pos = torch.arange(T, dtype=torch.int32)
    return [attn.decode_partials(
        q, k[:, i * w:(i + 1) * w], v[:, i * w:(i + 1) * w], q_pos,
        k_pos[i * w:(i + 1) * w], window=WINDOW, valid_len=valid,
        softcap=softcap) for i in range(parts)]


@pytest.mark.parametrize("softcap", [0.0, 5.0])
@pytest.mark.parametrize("parts", [2, 4])
def test_the_log_sum_exp_combine_is_attention_over_the_whole_window(
        parts, softcap):
    q, k, v = inputs()
    q_pos = torch.tensor(POS, dtype=torch.int32)[:, None]
    valid = (q_pos + 1)[:, :, None]                    # (B, 1, 1) per row
    pieces = split(q, k, v, q_pos, valid, parts, softcap)
    # a part with no allowed key for a row: max -inf, sum and output 0
    empty = [(i, r) for i in range(parts) for r in range(B)
             if bool(torch.isneginf(pieces[i][0][r]).all())]
    assert (parts - 1, 1) in empty
    if parts == 4:
        assert {(3, r) for r in range(B)} <= set(empty)
    for i, r in empty:
        m, l, o = pieces[i]
        assert float(l[r].abs().max()) == 0.0
        assert float(o[r].abs().max()) == 0.0
    got = attn.merge_partials(pieces, q.dtype)
    assert bool(torch.isfinite(got).all())
    want = attn.gqa_attention(q, k, v, q_pos, torch.arange(T), window=WINDOW,
                              causal=True, valid_len=valid, softcap=softcap)
    assert float((got - want).norm() / want.norm()) <= 1e-6
    exact = fp64_attention(q, k, v, q_pos, valid, softcap)
    assert float((got - exact).abs().max()) <= 1e-12 * float(
        exact.abs().max())


def test_a_row_with_no_allowed_key_comes_out_zero():
    q, k, v = inputs(1)
    q_pos = torch.tensor(POS, dtype=torch.int32)[:, None]
    valid = torch.tensor([0, 13, 21])[:, None, None]   # row 0: no key at all
    got = attn.merge_partials(split(q, k, v, q_pos, valid, 4, 0.0), q.dtype)
    assert bool(torch.isfinite(got).all())
    assert float(got[0].abs().max()) == 0.0
    exact = fp64_attention(q, k, v, q_pos, valid, 0.0)
    assert float((got[1:] - exact[1:]).abs().max()) <= 1e-12 * float(
        exact[1:].abs().max())


def test_a_shard_weighs_what_its_max_says():
    """The rescaling alone: a part whose max lies 40 below the row max
    enters with weight exp(-40), a part with none with 0."""
    m = torch.tensor([[-40.0], [-math.inf], [0.0]], dtype=torch.float64)
    top = torch.zeros(3, 1, dtype=torch.float64)
    packed = attn._weighted(m, top, torch.ones(3, 1, dtype=torch.float64),
                            torch.ones(3, 1, 2, dtype=torch.float64))
    assert packed[0].tolist() == [[math.exp(-40.0)] * 3]
    assert packed[1].tolist() == [[0.0] * 3]
    assert packed[2].tolist() == [[1.0] * 3]
    none = attn._weighted(torch.full((1, 1), -math.inf),
                          torch.full((1, 1), -math.inf),
                          torch.zeros(1, 1), torch.zeros(1, 1, 2))
    assert none.tolist() == [[[0.0, 0.0, 0.0]]]


def test_plain_tensors_take_the_helpers_unchanged():
    """On plain tensors (one process) the per-row write is the indexed
    assignment, the weight-stationary product the product, and the
    argmax torch's (ties to the first index)."""
    gen = torch.Generator().manual_seed(2)
    dst = torch.randn(4, 9, 2, 3, generator=gen)
    want = dst.clone()
    src = torch.randn(4, 1, 2, 3, generator=gen)
    pos = torch.tensor([3, 0, 8, 5])
    sdt.write_rows_at_(dst, pos, src)
    want[torch.arange(4), pos] = src[:, 0]
    assert torch.equal(dst, want)
    x, w = torch.randn(4, 1, 6, generator=gen), torch.randn(6, 5,
                                                            generator=gen)
    assert torch.equal(sdt.dense(x, w), x @ w)
    logits = torch.tensor([[1.0, 3.0, 3.0, 0.0], [2.0, 2.0, 2.0, 2.0]])
    assert sdt.argmax(logits).tolist() == [1, 0]


def test_the_decode_override_replicates_activations_and_keeps_weights():
    """Under the decode's rule override (the reference's ``act_batch``
    None, ``act_seq_cp`` None) an activation's batch is replicated over
    ('pod', 'data') and ``unshard_data`` gathers over no axis; outside
    it, where the batcher and the dry run place the cache, its slots lie
    over ('pod', 'data') and its sequence over 'model'."""
    from repro_torch.sharding.rules import rule_axes, rule_overrides, spec_for
    mesh = {"pod": 2, "data": 16, "model": 16}
    act = ((128, 1, 2560), ("act_batch", "act_seq", "act_embed"))
    assert spec_for(*act, mesh) == (("pod", "data"),)
    assert rule_axes("act_batch") == ("pod", "data")
    with rule_overrides(act_batch=None, act_seq_cp=None):
        assert spec_for(*act, mesh) == ()
        assert rule_axes("act_batch") == ()
    assert rule_axes("act_batch") == ("pod", "data")
    assert spec_for((128, 32768, 1, 256), ("act_batch", "act_cache_seq",
                                           "act_kv_heads", None), mesh) == (
        ("pod", "data"), "model")
