"""Weight bridge from the JAX package's flax variables."""
