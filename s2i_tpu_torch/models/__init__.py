"""NCHW torch modules of the serving path: encoder, CA net, generator."""
