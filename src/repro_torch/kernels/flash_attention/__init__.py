"""Online-softmax (flash) attention with GQA, causal offset and window."""
