"""PyTorch port of the FedAWE reproduction, for one NVIDIA H100.

The JAX package ``repro`` is the reference: every module here has one
counterpart there with the same file name and public names, and the tests
drive both from the same numpy inputs.  This package imports torch and
numpy only, never ``jax`` and nothing of ``repro``.

Entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU; ``device.resolve_device`` raises when the card is missing
rather than falling back.
"""
