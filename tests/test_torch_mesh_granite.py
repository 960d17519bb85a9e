"""Granite-8B (dense GQA, tied embeddings) smoke trained on the CPU meshes
(1, 2), (1, 4) and (2, 2): the port's sharded step on gloo ranks against
the reference's jitted step under its state and batch shardings
(tests/_torch_mesh.py)."""
from tests._torch_mesh import MeshCases, runs  # noqa: F401 (the fixture)

ARCH = "granite-8b"


class TestGraniteMesh(MeshCases):
    ARCH = ARCH
