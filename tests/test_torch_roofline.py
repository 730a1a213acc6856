"""repro_torch.launch.roofline against repro.launch.roofline.

The HLO text parser is the reference's, held to it on the same snippets;
the roofline terms are the reference's arithmetic at the H100's peaks.
"""

import pytest

from repro.launch import roofline as rroofline
from repro_torch.launch import roofline

_SNIPPET = """
  %ag = bf16[16,1024] all-gather(bf16[1,1024] %x), replica_groups={}
  %ar = f32[256] all-reduce(f32[256] %y), to_apply=%sum
  %rs.1 = f32[8,2] reduce-scatter(f32[64,2] %z), dimensions={0}
  %done = (f32[4]) all-reduce-done(f32[4] %w)
  %cp = u32[10] collective-permute(u32[10] %q)
"""
# a tuple result: every shape of the tuple counts
_TUPLE = """
  %a2a = (f32[4,64,1,64]{3,2,1,0}, f32[4,64,1,64]{3,2,1,0}) all-to-all(f32[4,64,1,64] %a, f32[4,64,1,64] %b)
  %ar.2 = (f32[], bf16[128,128]{1,0}) all-reduce(f32[] %c, bf16[128,128] %d), to_apply=%sum
"""
# an async pair: the -start's result counts, its -done does not again
_ASYNC = """
  %ags = bf16[8,512]{1,0} all-gather-start(bf16[1,512] %x), dimensions={0}
  %agd = bf16[8,512]{1,0} all-gather-done(bf16[8,512] %ags)
  %cps = u8[1000] collective-permute-start(u8[1000] %p)
  %cpd = u8[1000] collective-permute-done(u8[1000] %cps)
"""


@pytest.mark.parametrize("text", [_SNIPPET, _TUPLE, _ASYNC], ids=["reference", "tuple", "async"])
def test_collective_bytes_matches_reference(text):
    assert roofline.collective_bytes(text) == rroofline.collective_bytes(text)


def test_collective_bytes_values():
    out = roofline.collective_bytes(_SNIPPET)
    assert out["all-gather"] == 16 * 1024 * 2
    assert out["all-reduce"] == 256 * 4
    assert out["reduce-scatter"] == 8 * 2 * 4
    assert out["collective-permute"] == 10 * 4
    tup = roofline.collective_bytes(_TUPLE)
    assert tup == {"all-to-all": 2 * 4 * 64 * 64 * 4, "all-reduce": 4 + 128 * 128 * 2}
    assert roofline.collective_bytes(_ASYNC) == {"all-gather": 8 * 512 * 2, "collective-permute": 1000}


def test_roofline_terms_math_at_h100_peaks():
    hw = roofline.HW
    rl = roofline.roofline_terms(
        arch="a", shape="s", mesh_name="single", chips=256,
        cost={"flops": hw["peak_flops"], "bytes accessed": hw["hbm_bw"]},
        hlo_text="%x = bf16[25000000000,1] all-reduce(bf16[1] %y)",
        model_flops=hw["peak_flops"] * 256,
    )
    assert rl.t_compute == pytest.approx(1.0)
    assert rl.t_memory == pytest.approx(1.0)
    assert rl.t_collective == pytest.approx(1.0)
    assert rl.useful_ratio == pytest.approx(1.0)
    assert rl.to_dict().keys() == rroofline.Roofline(**rl.to_dict()).to_dict().keys()


def test_hw_is_the_h100():
    assert roofline.HW == {"peak_flops": 989e12, "hbm_bw": 3.35e12, "ici_bw": 50e9}
