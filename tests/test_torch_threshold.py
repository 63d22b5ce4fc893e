"""Port adaptive threshold against the JAX package: a 50-step recurrence.

Both keep three f32 scalars with a Kahan-compensated running sum; the model
deviations are fed from numpy. The rotation angle comes from atan2 in both,
so sigma agrees to f32 rounding (rtol 1e-5) after 50 steps, including steps
below min_motion_th (not accumulated) and a diverged one (clamped to 1e3).
"""

import numpy as np
import jax.numpy as jnp
import torch

from kiss_icp_tpu.ops import se3 as jse3
from kiss_icp_tpu.ops import threshold as jthr
from kiss_icp_tpu_torch.ops import threshold

torch.set_num_threads(1)


def test_threshold_recurrence_50_steps():
    rng = np.random.default_rng(0)
    ours = threshold.init_state(2.0)
    ref = jthr.init_state(2.0)
    kw = dict(max_range=100.0, min_motion_th=0.1)
    for i in range(50):
        twist = np.concatenate([rng.normal(0, 0.05, 3),
                                rng.normal(0, 3e-4, 3)]).astype(np.float32)
        if i % 7 == 3:
            twist *= np.float32(1e-3)  # below min_motion_th: not accumulated
        dev = np.array(jse3.se3_exp(jnp.asarray(twist)))
        if i == 20:
            dev[:3, 3] = np.float32(1e30)  # diverged frame: clamped to 1e3
        ours = threshold.update_model_deviation(ours, torch.from_numpy(dev), **kw)
        ref = jthr.update_model_deviation(ref, jnp.asarray(dev), **kw)
        np.testing.assert_allclose(float(threshold.compute_threshold(ours)),
                                   float(jthr.compute_threshold(ref)), rtol=1e-5)
        assert float(ours.num_samples) == float(ref.num_samples)
    np.testing.assert_allclose(float(ours.model_sse), float(ref.model_sse), rtol=1e-5)
    assert np.isfinite(float(ours.sse_comp))
