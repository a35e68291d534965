"""The example scripts of ``examples/``, on the port: each runs as ``python
-m fast_solver_lippmann_schwinger_tpu_torch.examples.<name>`` with the flags
of its JAX twin (``--cpu`` runs on the host, ``--x64`` in complex128; the
card otherwise), and has a ``main(argv)`` that returns what it prints."""
