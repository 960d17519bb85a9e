"""The port's own copies of the host I/O modules the serve driver reaches.

``metrics``, ``transport``, ``fabric``, ``storage``, ``arena``,
``credentials``, ``hints``, ``ratelimit`` and ``backend`` are copies of
their ``repro.core`` namesakes (jax-free Python), trimmed only of code
the serve path cannot reach; ``calibrate`` is the read side of the
MLServe calibration, with a byte-identical copy of its
``calibration.json``. Every constant keeps the reference's value.
"""
