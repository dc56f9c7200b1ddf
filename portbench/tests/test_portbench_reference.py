"""The frozen reference against the port's plain versions, and the input
generator, on the CPU at a tiny size.  (The tests may import the port; the
reference may not.)"""
import torch

from cloudsc2_tpu_torch.parallel.step import forward_step
from cloudsc2_tpu_torch.params import make_constants
from cloudsc2_tpu_torch.physics.adjoint import cloudsc2_ad
from cloudsc2_tpu_torch.physics.diagnostics import eta_levels
from cloudsc2_tpu_torch.physics.increment import state_increment
from cloudsc2_tpu_torch.physics.saturation import saturation
from cloudsc2_tpu_torch.physics.tangent_linear import cloudsc2_tl
from portbench import generate
from portbench.reference import steps

CPU = torch.device("cpu")


def test_generator_is_seeded_and_plausible():
    a = generate.synthesize(16, 137, 2**31 + 7, 1, CPU)
    b = generate.synthesize(16, 137, 2**31 + 7, 1, CPU)
    c = generate.synthesize(16, 137, 2**31 + 7, 2, CPU)
    assert list(a) == list(generate.FIELDS)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["t"], c["t"])
    assert a["aph"].shape == (138, 16) and a["t"].shape == (137, 16) and a["t"].dtype == torch.float64
    assert 150 < float(a["t"].min()) and float(a["t"].max()) < 340
    assert float(a["q"].min()) >= 0 and float(a["ql"].min()) >= 0 and float(a["qi"].min()) >= 0
    assert float(a["mfd"].max()) <= 0 <= float(a["mfu"].min())


def test_reference_nl_step_is_the_port_plain_step():
    inputs = {k: v.to(torch.float32) for k, v in generate.synthesize(8, 137, 3, 0, CPU).items()}
    want = steps.nl_step(inputs, generate.DT, steps.constants({}))
    x = dict(inputs, eta=eta_levels(inputs["ap"], inputs["aph"]))
    tends, diags = forward_step(x, generate.DT, make_constants(), fuse_saturation=True)
    got = {**{"tnd_" + k: v for k, v in tends.items()}, **diags}
    assert set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in want)


def test_reference_iteration_is_the_port_plain_tl_then_ad():
    """One vjp of the frozen TL gives bitwise what the port's plain TL and
    its plain AD (a vjp at zero) give."""
    inputs = generate.synthesize(4, 137, 4, 0, CPU)
    want = steps.tlad_iteration(inputs, generate.DT, steps.constants({}), 0.01)
    c = make_constants()
    s = dict(inputs, eta=eta_levels(inputs["ap"], inputs["aph"]))
    s["qsat"] = saturation(s["ap"], s["t"], kflag=1, lphylin=c.LPHYLIN, c=c)
    s.update(state_increment(s, 0.01, ignore_supsat=True))
    tends, diags = cloudsc2_tl(s, generate.DT, c, tangent_only=True)
    seeded = dict(s, **{"tnd_" + k: v for k, v in tends.items()}, **diags)
    cot_tends, cot_diags = cloudsc2_ad(seeded, generate.DT, c, cotangent_only=True)
    got = {**{"tl." + k: v for k, v in {**tends, **diags}.items()},
           **{"ad." + k: v for k, v in {**cot_tends, **cot_diags}.items()}}
    assert set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in want)
