"""Functions on NHWC tensors: convs, resize, morphology, partial conv."""
