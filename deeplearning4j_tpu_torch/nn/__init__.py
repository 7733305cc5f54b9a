"""Config DSL, layers, activations and initializers of the port."""
