"""The port's own copies of the Nexus core: host I/O and the worker node.

Copies of their ``repro.core`` namesakes (jax-free Python), trimmed only
of code the port's paths cannot reach, each saying what it left out:
``metrics``, ``transport``, ``fabric``, ``storage``, ``streaming``,
``arena``, ``credentials``, ``hints``, ``ratelimit``, ``backend``,
``faults``, ``guardrails``, ``workloads``, ``plan``, ``lifecycle``,
``supervisor``, ``frontend``, ``analysis`` and ``runtime`` (the
worker node); ``calibrate`` is the read side of the MLServe calibration,
with a byte-identical copy of its ``calibration.json``. Every constant
keeps the reference's value.
"""
