"""Shared set-up of the port's parity tests (tests/test_torch_*.py).

Each parity file imports ``fast_reference_compiles``; being an autouse
module fixture, it then wraps the whole file.
"""
import jax
import pytest

_FLAG = "jax_disable_most_optimizations"


@pytest.fixture(scope="module", autouse=True)
def fast_reference_compiles():
    """The reference's JAX programs compiled at XLA's lowest optimisation
    level for the file: on these tiny configurations compiling, not
    running, is their cost. Same programs, same tolerances. The flag is
    restored after the file and the compiled programs dropped, so a later
    file in the same worker (the JAX package's own tests too) compiles
    with its usual optimisations."""
    before = jax.config.read(_FLAG)
    jax.config.update(_FLAG, True)
    yield
    jax.config.update(_FLAG, before)
    jax.clear_caches()
