"""repro_torch — the Multiverse STM ported to PyTorch and CUDA (Hopper).

A second package beside the JAX reference ``repro``: the same modules at
the same relative paths, written over torch tensors.  The word-level
STM's heap, packed lock words and version mirror live on the device, and
its four hot kernels (``kernels/``) are hand-written CUDA C++ for
``sm_90a``.  Entry points run on the card unless the caller passes
``device="cpu"``:

    from repro_torch.api import make_tm, run
    tm = make_tm("multiverse", n_threads=4, array_heap=True)
"""
