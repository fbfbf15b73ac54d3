"""Tools of the port: the quality gate and its synthetic corpus."""
