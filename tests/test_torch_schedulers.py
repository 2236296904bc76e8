"""Parity of the port's DDIM, PNDM, Euler and UniPC samplers with the JAX package's.

For each scheduler: its tables, and a 4-step trajectory over a fixed sequence of
model outputs, driven through the port schedulers' own loop interface
(``set_timesteps``, ``init_state``, ``model_input``, ``step``, ``get_sample``, as the
port pipeline calls it) and through the JAX calls the JAX pipeline makes (``pipelines/text_to_image.py`` :234-281). fp32
on both sides, atol 1e-5. Then the analytic goldens that
``tests/test_scheduler_golden.py`` pins for the JAX Euler and UniPC samplers (the same
float64 literals, derived there from the published formulas) hold for the port.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from controllora_tpu import schedulers as jsch
from controllora_tpu_torch import schedulers as tsch

ATOL = 1e-5
NAMES = ("ddim", "pndm", "euler", "unipc")
PORT = {"ddim": tsch.DDIMScheduler, "pndm": tsch.PNDMScheduler,
        "euler": tsch.EulerDiscreteScheduler, "unipc": tsch.UniPCMultistepScheduler}
JAX = {"ddim": jsch.DDIMScheduler, "pndm": jsch.PNDMScheduler,
       "euler": jsch.EulerDiscreteScheduler, "unipc": jsch.UniPCMultistepScheduler}

# float64 literals of tests/test_scheduler_golden.py (SD1.5 schedule, 4 steps)
ALPHA4_GOLDEN = np.array([0.0682649142171675, 0.2379569112219053, 0.5256735525237831,
                          0.8208487225020951, 0.9995749096490968])
SIGMAS4_GOLDEN = np.array([14.61464123, 2.91830712, 0.93235797, 0.02916716, 0.0])
EULER_TRAJ4_GOLDEN = np.array([14.32049995, 14.71768978, 14.26609438, 14.26901109])
UNIPC_TRAJ4_GOLDEN = np.array([5.17392317, 12.69821336, 19.47522368, 23.64648348])


def jax_protocol(name, n):
    """(ts, init_state, model_input, step, get_sample) as the JAX pipeline builds them."""
    sch = JAX[name]()
    if name in ("ddim", "pndm"):
        ts = sch.timesteps(n)
        last = max(int(ts[-1] - (ts[0] - ts[1])), -1) if name == "pndm" else -1
        ts_prev = list(ts[1:]) + [last]
        if name == "ddim":
            return (ts, lambda x: x, lambda s, i: s,
                    lambda s, e, i: sch.step(e, jnp.int32(ts[i]), jnp.int32(ts_prev[i]), s),
                    lambda s: s)
        return (ts, sch.init_state, lambda s, i: s.sample,
                lambda s, e, i: sch.step(s, e, jnp.int32(ts[i]), jnp.int32(ts_prev[i])),
                lambda s: s.sample)
    if name == "euler":
        ts, sigmas = sch.tables(n)
        return (ts, lambda x: sch.init_state(x, sigmas),
                lambda s, i: sch.model_input(s, sigmas[i]),
                lambda s, e, i: sch.step(s, e, jnp.asarray(i), sigmas), lambda s: s)
    tables = sch.tables(n)
    return (tables[0], sch.init_state, lambda s, i: s.sample,
            lambda s, e, i: sch.step(s, e, jnp.asarray(i), n, tables), lambda s: s.sample)


@pytest.mark.parametrize("name", NAMES)
def test_tables_match_jax(name):
    port, ref = PORT[name](), JAX[name]()
    for n in (4, 20):
        if name in ("ddim", "pndm"):
            np.testing.assert_array_equal(port.timesteps(n), ref.timesteps(n))
        else:
            for a, b in zip(port.tables(n), ref.tables(n)):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("name", NAMES)
def test_trajectory_matches_jax(name):
    rng = np.random.default_rng(3)
    x0 = rng.normal(size=(2, 4, 3, 3)).astype(np.float32)
    eps_seq = [rng.normal(size=x0.shape).astype(np.float32) for _ in range(4)]
    sch = PORT[name]()
    sch.set_timesteps(4)
    ts, init, model_input, step, get_sample = jax_protocol(name, 4)
    np.testing.assert_array_equal(np.asarray(sch.ts), np.asarray(ts))
    state, jstate = sch.init_state(torch.from_numpy(x0)), init(jnp.asarray(x0))
    for i, e in enumerate(eps_seq):
        np.testing.assert_allclose(sch.model_input(state, i).numpy(),
                                   np.asarray(model_input(jstate, i)), rtol=0, atol=ATOL)
        state = sch.step(state, torch.from_numpy(e), i)
        jstate = step(jstate, jnp.asarray(e), i)
        np.testing.assert_allclose(sch.get_sample(state).numpy(),
                                   np.asarray(get_sample(jstate)), rtol=0, atol=ATOL,
                                   err_msg=f"{name} step {i}")


def scalar(v):
    return torch.full((1, 1, 1, 1), v, dtype=torch.float32)


def test_euler_golden():
    sch = tsch.EulerDiscreteScheduler()
    sch.set_timesteps(4)
    ts, sigmas = sch.ts, sch.sigmas
    np.testing.assert_allclose(ts, [999.0, 666.0, 333.0, 0.0])
    np.testing.assert_allclose(sigmas.astype(np.float64), SIGMAS4_GOLDEN, rtol=2e-5,
                               atol=1e-7)
    np.testing.assert_allclose(float(sch.model_input(scalar(1.0), 0)),
                               ALPHA4_GOLDEN[0], rtol=2e-5)
    x = sch.init_state(scalar(1.3))
    for i, e in enumerate([0.4, -0.2, 0.5, -0.1]):
        x = sch.step(x, scalar(e), i)
        np.testing.assert_allclose(float(x), EULER_TRAJ4_GOLDEN[i], rtol=3e-4)


def test_unipc_golden():
    sch = tsch.UniPCMultistepScheduler()
    sch.set_timesteps(4)
    state = sch.init_state(scalar(1.7))
    for i, e in enumerate([0.3, -0.5, 0.2, 0.1]):
        state = sch.step(state, scalar(e), i)
        np.testing.assert_allclose(float(state.sample), UNIPC_TRAJ4_GOLDEN[i], rtol=3e-4)
