"""Models of the port: the HGNNs (``models.hgnn``) and the LM decoder
(``models.lm``)."""
