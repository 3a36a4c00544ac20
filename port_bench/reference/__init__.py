"""Plain float32 references of the served configurations: nothing here
imports the port, JAX or the JAX package."""
