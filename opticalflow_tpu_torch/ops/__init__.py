"""Ops on NCHW tensors: correlation (plain + CUDA), warp, resize, convs."""
