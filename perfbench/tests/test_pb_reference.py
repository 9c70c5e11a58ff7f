"""The references read the call's keyword arguments and the configuration,
and refuse what they do not compute."""

import numpy as np
import pytest
from conftest import TINY

from pbcore import data, manifest


def inputs(name):
    cfg = manifest.config(name)
    return cfg, data.load_pattern(cfg["pattern"], TINY["users"], TINY["items"])


@pytest.mark.parametrize("keyword", ["shrink", "threshold", "binary", "alpha"])
def test_item_cosine_refuses_a_keyword_it_does_not_compute(keyword):
    cfg, pattern = inputs("ml32m-raw-int8")
    call = {**cfg["build"], "kwargs": {**cfg["build"]["kwargs"], keyword: 1}}
    with pytest.raises(ValueError, match=keyword):
        manifest.reference("item_cosine").Reference(pattern, call, cfg, "cpu")


def test_item_cosine_refuses_another_function():
    cfg, pattern = inputs("ml32m-raw-int8")
    with pytest.raises(ValueError, match="jaccard"):
        manifest.reference("item_cosine").Reference(pattern, {**cfg["build"], "function": "jaccard"},
                                                    cfg, "cpu")


@pytest.mark.parametrize("change,match", [
    ({"weighting": {"function": "bm25", "kwargs": {"k1": 2.0}}}, "k1"),
    ({"weighting": {"function": "tfidf", "kwargs": {}}}, "tfidf"),
    ({"score": {"function": "dot_product", "kwargs": {"k": 10}}}, "seen"),
])
def test_user_scores_refuses_what_it_does_not_compute(change, match):
    cfg, pattern = inputs("ml32m-bm25-f32")
    cfg = {**cfg, **change}
    values = np.ones(pattern.nnz, np.float32)
    model = manifest.part("models", "popularity").draw(1, pattern.item_counts(),
                                                        {"per_row": 5}, "cpu")
    with pytest.raises(ValueError, match=match):
        manifest.reference("user_scores").Reference(pattern, values, model, cfg["score"], cfg,
                                                    "cpu")


def test_item_cosine_takes_k_from_the_call():
    cfg, pattern = inputs("ml32m-raw-int8")
    values = manifest.part("values", "half_stars").Values(5, pattern.nnz, "cpu")(0)
    module = manifest.reference("item_cosine")
    call = {**cfg["build"], "kwargs": {**cfg["build"]["kwargs"], "k": 7}}
    rows = module.Reference(pattern, call, cfg, "cpu").rows(values, [0, 1, 2])
    assert all(v.shape[0] <= 7 for v in rows.vals)
    wide = module.Reference(pattern, cfg["build"], cfg, "cpu").rows(values, [0, 1, 2])
    assert any(v.shape[0] > 7 for v in wide.vals)
