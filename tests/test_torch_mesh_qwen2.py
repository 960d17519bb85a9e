"""Qwen2-72B (dense GQA, QKV bias) smoke trained on the CPU meshes
(1, 2), (1, 4) and (2, 2): the port's sharded step on gloo ranks against
the reference's jitted step under its state and batch shardings
(tests/_torch_mesh.py)."""
from tests._torch_mesh import MeshCases, runs  # noqa: F401 (the fixture)

ARCH = "qwen2-72b"


class TestQwen2Mesh(MeshCases):
    ARCH = ARCH
