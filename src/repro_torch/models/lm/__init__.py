"""The LM decoder of the port (dense family): configs, parameter specs,
attention with kernel #7 on its full-sequence path, and the decode step
the greedy server drives."""
