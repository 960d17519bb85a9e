"""The dry run's depth extrapolation (`repro_torch.launch.dryrun`): the
depth-1 and depth-2 meta passes extrapolated to L against the pass of
all L layers, and the one-block setting of the plain path the passes
run under.
"""
import pytest

from repro_torch.configs import ARCH_IDS, InputShape, registry
from repro_torch.kernels.flash_attention import ref as attention_ref
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as M
from repro_torch.models import mamba


EXTRAPOLATED = {"train": InputShape("train", 64, 2, "train"),
                "prefill": InputShape("prefill", 64, 2, "prefill"),
                "decode": InputShape("decode", 96, 2, "decode")}


@pytest.mark.parametrize("kind", list(EXTRAPOLATED))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_one_layer_x_L_equals_the_full_pass(arch, kind):
    """Each smoke config at 4 layers (past its window at decode): the
    depth-1 and depth-2 passes extrapolated to 4 give the 4-layer pass's
    FLOPs and output bytes exactly, on both production meshes."""
    cfg = dryrun.at_depth(registry.get_smoke(arch), 4)
    shape = EXTRAPOLATED[kind]
    for multi in (False, True):
        mesh = M.make_production_mesh(multi_pod=multi)
        fast = dryrun.pass_figures(cfg, shape, mesh)
        full = dryrun.pass_figures(cfg, shape, mesh, full_depth=True)
        assert (fast["by"], full["by"]) == (dryrun.ONE_LAYER,
                                            dryrun.FULL_PASS)
        assert (fast["flops"], fast["output_B"]) == (full["flops"],
                                                     full["output_B"])
        assert fast["flops"] > 0 and fast["output_B"] > 0


def test_one_block_restores_the_plain_blocking():
    saved = attention_ref.SCORE_ELEMS, mamba.SCAN_CHUNK
    with pytest.raises(RuntimeError):
        with dryrun.one_block():
            assert attention_ref.SCORE_ELEMS == mamba.SCAN_CHUNK == 1 << 62
            raise RuntimeError
    assert (attention_ref.SCORE_ELEMS, mamba.SCAN_CHUNK) == saved
