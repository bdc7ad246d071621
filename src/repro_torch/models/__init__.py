"""HGNN models of the port."""
