"""The paper's scheduling core (jax-free copies)."""
