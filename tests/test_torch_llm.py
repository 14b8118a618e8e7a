"""The port's LLM-scored selection (`bayesvlm_tpu_torch.select.llm`)
against the JAX package's (`bayesvlm_tpu.select.llm`): the prompt strings
character for character, the score parse, `select_llm_score`'s indices
and scores with one deterministic stub client (exact: both parse the same
strings and sort with numpy's stable sort), its pacing through an
injected `sleep_fn`, and the Gemini client driven through a fake
`google.generativeai` module, as tests/test_llm_client.py drives the JAX
package's: joined parts, the BLOCKED marker, the linear backoff on a quota
error, the fixed delay on another, the missing key. Nothing reaches a
network."""

import sys
import types
import zlib

import numpy as np
import pytest

from bayesvlm_tpu.select import llm as jax_llm
from bayesvlm_tpu_torch.select import llm

CAPTIONS = ["a photo", "", "it's 'quoted'", "ünïcode ✓", "x" * 200]
PROMPTS = ["a photo of a cat", "", "a 'dog'", "a Bürste"]


def crc_client(prompt: str):
    """A deterministic stand-in for an LLM: a score from the prompt's crc32
    (some unparsable, blocked or empty answers among them)."""
    h = zlib.crc32(prompt.encode())
    kind = h % 7
    if kind == 0:
        return None
    if kind == 1:
        return "BLOCKED: SAFETY"
    if kind == 2:
        return "no idea"
    return f"Score: {1 + (h >> 3) % 9 * 0.5}"


@pytest.mark.parametrize("caption", CAPTIONS)
@pytest.mark.parametrize("prompt", PROMPTS)
def test_prompts_are_equal(caption, prompt):
    assert llm.difficulty_prompt(caption, prompt) == jax_llm.difficulty_prompt(caption, prompt)
    assert llm.value_prompt(caption, prompt) == jax_llm.value_prompt(caption, prompt)


@pytest.mark.parametrize("image_id", [0, 7, 123456])
def test_caption_placeholder_is_equal(image_id):
    for info in ("", "homeoffice-da-clipart", "cifar100"):
        assert (llm.caption_placeholder(image_id, info)
                == jax_llm.caption_placeholder(image_id, info))


def test_parse_is_equal():
    texts = [None, "", "BLOCKED: SAFETY", "5", "0", "6", "3.75 out of 5", "score 4.", "9",
             "a 2", "1.0", "5.5", "no digits", "10", "the answer: 2.25!"]
    got = [llm.parse_llm_score(t) for t in texts]
    assert got == [jax_llm.parse_llm_score(t) for t in texts]
    assert got[:7] == [None, None, None, 5.0, None, None, 3.75]


@pytest.mark.parametrize("score_type", ["difficulty", "value"])
@pytest.mark.parametrize("k", [1, 7, 100])
def test_select_llm_score_matches_jax(score_type, k):
    rng = np.random.default_rng(0)
    ids = rng.permutation(1000)[:60]
    classes = rng.integers(0, 5, size=60)  # class 4 has no prompt: skipped
    prompts = ["a cat", "a dog", "a car", "a cup"]
    calls = {"port": 0, "jax": 0}

    def counted(name):
        def client(p):
            calls[name] += 1
            return crc_client(p)
        return client

    kw = dict(k=k, llm_score_type=score_type, dataset_name="synthetic",
              rate_limit_delay=0.0, sleep_fn=lambda s: None)
    idx, scores = llm.select_llm_score(ids, classes, prompts, client=counted("port"), **kw)
    j_idx, j_scores = jax_llm.select_llm_score(ids, classes, prompts,
                                               client=counted("jax"), **kw)
    assert idx.tolist() == j_idx.tolist() and scores.tolist() == j_scores.tolist()
    assert idx.dtype == np.int64 and scores.dtype == np.float32
    assert calls["port"] == calls["jax"] == int((classes < 4).sum())
    assert not set(idx.tolist()) & set(np.flatnonzero(classes >= 4).tolist())
    assert len(idx) == min(k, calls["port"])
    # 2.5 where the answer did not parse, and a stable descending order
    if k == 100:
        assert 2.5 in scores.tolist()
    assert all(a >= b for a, b in zip(scores, scores[1:]))


def test_no_candidate_left():
    idx, scores = llm.select_llm_score([1, 2], [5, 6], ["a"], k=3, client=crc_client,
                                       sleep_fn=lambda s: None)
    assert idx.size == 0 and scores.size == 0
    assert idx.dtype == np.int64 and scores.dtype == np.float32


def test_unknown_score_type_is_refused():
    with pytest.raises(ValueError, match="Invalid llm_score_type"):
        llm.select_llm_score([1], [0], ["a"], k=1, client=crc_client,
                             llm_score_type="novelty")


def test_calls_are_paced_through_sleep_fn():
    """Call i waits until i * delay after the first: an instant client
    sleeps about i * delay before call i, as in JAX."""
    slept = {"port": [], "jax": []}
    for name, mod in (("port", llm), ("jax", jax_llm)):
        mod.select_llm_score(np.arange(5), np.zeros(5, int), ["a"], k=5,
                             client=lambda p: "3", rate_limit_delay=10.0,
                             sleep_fn=slept[name].append)
    for name in slept:
        # i * delay less the (host-clock) time the loop took so far
        assert len(slept[name]) == 4
        assert all(10.0 * i - 1.0 < s <= 10.0 * i for i, s in enumerate(slept[name], 1))


class _Part:
    def __init__(self, text):
        self.text = text


class _Response:
    def __init__(self, parts=(), block_reason=None):
        self.parts = list(parts)
        self.prompt_feedback = (types.SimpleNamespace(block_reason=block_reason)
                                if block_reason is not None else None)


@pytest.fixture
def fake_genai(monkeypatch):
    """A fake google.generativeai with a scriptable model, and no sleep."""
    genai = types.ModuleType("google.generativeai")
    state = {"key": None, "model": None, "script": [], "calls": 0, "slept": []}

    class GenerativeModel:
        def __init__(self, name):
            state["model"] = name

        def generate_content(self, prompt):
            state["calls"] += 1
            action = state["script"].pop(0)
            if isinstance(action, Exception):
                raise action
            return action

    genai.configure = lambda api_key=None: state.update(key=api_key)
    genai.GenerativeModel = GenerativeModel
    google = types.ModuleType("google")
    google.generativeai = genai
    monkeypatch.setitem(sys.modules, "google", google)
    monkeypatch.setitem(sys.modules, "google.generativeai", genai)
    monkeypatch.setenv("GEMINI_API_KEY", "key-1")
    monkeypatch.setattr(llm.time, "sleep", state["slept"].append)
    return state


def test_client_joins_parts(fake_genai):
    fake_genai["script"] = [_Response(parts=[_Part("The score is "), _Part("4")])]
    client = llm.make_gemini_client(model_name="gemini-pro")
    assert client("p") == "The score is 4"
    assert (fake_genai["key"], fake_genai["model"]) == ("key-1", "gemini-pro")


def test_client_block_and_empty(fake_genai):
    fake_genai["script"] = [_Response(block_reason="SAFETY"), _Response()]
    client = llm.make_gemini_client()
    out = client("p")
    assert out == "BLOCKED: SAFETY" and llm.parse_llm_score(out) is None
    assert client("p") is None
    assert fake_genai["slept"] == []


def test_client_backoff(fake_genai):
    fake_genai["script"] = [Exception("429 Resource has been exhausted"),
                            Exception("Resource has been exhausted (quota)"),
                            Exception("500 internal"),
                            _Response(parts=[_Part("3")])]
    client = llm.make_gemini_client(retry_delay=5, max_retries=4)
    assert client("p") == "3"
    # quota errors: retry_delay * (attempt + 1); others: retry_delay
    assert fake_genai["slept"] == [5, 10, 5]


def test_client_gives_up_after_max_retries(fake_genai):
    fake_genai["script"] = [Exception("boom")] * 3
    assert llm.make_gemini_client(retry_delay=7, max_retries=3)("p") is None
    assert fake_genai["calls"] == 3 and fake_genai["slept"] == [7, 7, 7]


def test_client_needs_its_key(fake_genai, monkeypatch):
    monkeypatch.delenv("GEMINI_API_KEY")
    with pytest.raises(ValueError, match="GEMINI_API_KEY"):
        llm.make_gemini_client()


def test_client_needs_its_package(monkeypatch):
    monkeypatch.setitem(sys.modules, "google.generativeai", None)
    with pytest.raises(ImportError):
        llm.make_gemini_client()


def test_selection_through_the_fake_client(fake_genai):
    fake_genai["script"] = [_Response(parts=[_Part("5")]),
                            _Response(block_reason="SAFETY"),
                            _Response(parts=[_Part("1 is my score")])]
    idx, scores = llm.select_llm_score(np.array([10, 11, 12]), np.array([0, 1, 0]),
                                       ["a cat", "a dog"], k=3,
                                       client=llm.make_gemini_client(),
                                       dataset_name="testset", sleep_fn=lambda s: None)
    assert scores.tolist() == [5.0, 2.5, 1.0] and idx.tolist() == [0, 1, 2]
