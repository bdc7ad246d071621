"""The LM side of the port: configs, parameter specs, the decoder stack
(dense, MoE, recurrent and VLM families; attention with kernel #7 on its
full-sequence path), the encoder-decoder, and the decode steps the
servers drive."""
