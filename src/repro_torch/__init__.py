"""repro_torch — the PyTorch/CUDA port of the AVEC reproduction.

It serves the destination side of one offloaded dense-LM call on an NVIDIA
H100: the AVC2 wire, the destination executor and host runtime, the dense
decoder models, and hand-written CUDA kernels for the norms and attention.
It imports ``torch``, numpy and the standard library only.
"""
