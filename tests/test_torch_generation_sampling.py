"""paddle_tpu_torch's seeded sampling in ``generate`` (split from
``test_torch_generation.py``, whose models and helpers it shares): the same
seed gives the same tokens.
"""


import pytest
import torch


from test_torch_generation import (  # noqa: F401 — shared helpers
    PROMPTS, pairs)


@pytest.mark.parametrize("kind", ["llama", "gpt"])
def test_seeded_sampling_is_reproducible(pairs, kind):
    _, tm = pairs[kind]
    p = torch.from_numpy(PROMPTS)
    kw = dict(max_new_tokens=8, do_sample=True, temperature=2.0)
    a = tm.generate(p, seed=5, **kw)
    assert torch.equal(a, tm.generate(p, seed=5, **kw))
    assert not torch.equal(a, tm.generate(p, seed=6, **kw))
    assert not torch.equal(tm.generate(p, **kw), tm.generate(p, **kw))
    # top_k = 1 sampling is greedy
    assert torch.equal(tm.generate(p, max_new_tokens=4, do_sample=True,
                                   top_k=1, seed=9),
                       tm.generate(p, max_new_tokens=4))
