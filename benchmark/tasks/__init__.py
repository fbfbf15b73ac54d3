"""One module per kind of training step the benchmark drives."""
