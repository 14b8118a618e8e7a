"""LLM-scored data selection (ref:scripts/activelearning_llm.py:269-489),
the counterpart of `bayesvlm_tpu.select.llm` (numpy only; this copy
imports nothing of the JAX package).

A pluggable client replaces the hard Gemini dependency: any callable
`prompt -> Optional[str]` works (the Gemini client is built lazily when
`google.generativeai` is importable and GEMINI_API_KEY is set). Prompt
templates, the 1-5 regex score parse with clamping, retry/backoff, rate
limiting and the default-score fallback all mirror the reference, the
prompt strings character for character.
"""

from __future__ import annotations

import os
import re
import time
from typing import Callable, List, Optional, Tuple

import numpy as np


def parse_llm_score(response_text: Optional[str]) -> Optional[float]:
    """First 1-5 number in the response, clamped
    (ref:activelearning_llm.py:349-369)."""
    if response_text is None or response_text.startswith("BLOCKED"):
        return None
    match = re.search(r"([1-5](?:\.\d+)?)", response_text)
    if not match:
        return None
    return max(1.0, min(5.0, float(match.group(1))))


def difficulty_prompt(caption: str, vlm_text_prompt: str) -> str:
    fmt = " Respond with only the numerical score (1-5)."
    return (
        f"Image Description: '{caption}'. Text Prompt: '{vlm_text_prompt}'. "
        f"How challenging (1=very easy, 5=very difficult) is it to "
        f"definitively match this text prompt to this specific image, "
        f"considering ambiguities, visual complexity, or subtle "
        f"distinctions?{fmt}"
    )


def value_prompt(caption: str, vlm_text_prompt: str) -> str:
    fmt = " Respond with only the numerical score (1-5)."
    return (
        f"Image Description: '{caption}'. Text Prompt: '{vlm_text_prompt}'. "
        f"This image-text pair was identified as potentially uncertain for a "
        f"vision model. Plausible reasons include subtle visual cues, "
        f"semantic ambiguity, unusual presentation, mismatch, or concept "
        f"novelty. How valuable (1=low, 5=high) do you estimate this example "
        f"would be for improving the model?{fmt}"
    )


def caption_placeholder(image_id: int, dataset_info: str) -> str:
    """ref:activelearning_llm.py:291-298."""
    return f"Image content related to dataset '{dataset_info}' with ID {image_id}."


def make_gemini_client(
    model_name: str = "gemini-pro",
    retry_delay: int = 5,
    max_retries: int = 3,
) -> Callable[[str], Optional[str]]:
    """Gemini client with retries/backoff (ref:activelearning_llm.py:301-345).
    Raises ImportError/ValueError when unavailable — callers should fall
    back to a stub or fail loudly."""
    import google.generativeai as genai  # optional dependency

    api_key = os.getenv("GEMINI_API_KEY")
    if not api_key:
        raise ValueError("GEMINI_API_KEY environment variable not set")
    genai.configure(api_key=api_key)
    model = genai.GenerativeModel(model_name)

    def call(prompt: str) -> Optional[str]:
        attempts = 0
        while attempts < max_retries:
            try:
                response = model.generate_content(prompt)
                if response.parts:
                    return "".join(
                        p.text for p in response.parts if hasattr(p, "text")
                    )
                if response.prompt_feedback and response.prompt_feedback.block_reason:
                    return f"BLOCKED: {response.prompt_feedback.block_reason}"
                return None
            except Exception as e:
                msg = str(e)
                if "429" in msg or "resource has been exhausted" in msg.lower():
                    time.sleep(retry_delay * (attempts + 1))
                else:
                    time.sleep(retry_delay)
                attempts += 1
        return None

    return call


def select_llm_score(
    image_ids,
    image_class_ids,
    class_prompts: List[str],
    k: int,
    client: Callable[[str], Optional[str]],
    llm_score_type: str = "difficulty",
    dataset_name: str = "",
    rate_limit_delay: float = 1.1,
    default_score: float = 2.5,
    sleep_fn: Callable[[float], None] = time.sleep,
) -> Tuple[np.ndarray, np.ndarray]:
    """Score every candidate with the LLM, return top-k (indices, scores)
    (ref:activelearning_llm.py:378-489)."""
    image_ids = np.asarray(image_ids)
    image_class_ids = np.asarray(image_class_ids)
    n = len(image_ids)

    template = difficulty_prompt if llm_score_type == "difficulty" else value_prompt
    if llm_score_type not in ("difficulty", "value"):
        raise ValueError("Invalid llm_score_type")

    scores, kept = [], []
    start = time.time()
    calls = 0
    for i in range(n):
        cid = int(image_class_ids[i])
        if cid >= len(class_prompts):
            continue
        caption = caption_placeholder(int(image_ids[i]), dataset_name)
        prompt = template(caption, class_prompts[cid])

        expected = calls * rate_limit_delay
        elapsed = time.time() - start
        if elapsed < expected:
            sleep_fn(expected - elapsed)

        response = client(prompt)
        calls += 1
        score = parse_llm_score(response)
        scores.append(default_score if score is None else score)
        kept.append(i)

    if not scores:
        return np.array([], np.int64), np.array([], np.float32)

    scores = np.asarray(scores, np.float32)
    kept = np.asarray(kept, np.int64)
    order = np.argsort(-scores, kind="stable")[:k]
    return kept[order], scores[order]
