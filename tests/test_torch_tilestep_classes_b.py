"""The per-model tests of tests/test_torch_tilestep_classes.py (extract,
one step, returns, against the JAX tile path) over the JAX tests' three
contact models; the tests, the fixtures and their tolerances are that
file's."""

from tests.test_torch_tilestep_classes import (  # noqa: F401 (collected)
    CLASS_MODELS, HALF_A, jax_run, models_fixture,
    test_class_model_extract_matches_jax, test_class_model_returns_match_jax,
    test_class_model_step_matches_jax)
from tests.torch_engine_cases import release_jax_executables  # noqa: F401

models = models_fixture(tuple(n for n in sorted(CLASS_MODELS)
                              if n not in HALF_A))
