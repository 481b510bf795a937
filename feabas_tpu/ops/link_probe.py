"""Host<->device link profiling for adaptive routing.

The same device program can be compute-bound on a local accelerator and
link-bound behind a slow host<->device link. Rather than baking one
deployment's constants into routing decisions (device-vs-host render,
dispatch group size, one-shot thumbnail routing), the first caller pays a
one-time probe and every router reads the measured numbers.

Reference role: the reference has a single host path and no routing to
decide (feabas/renderer.py:566); this module is what lets the device
build default ``device.render: auto`` without regressing slow-link
deployments.
"""

import threading
import time

import numpy as np

_LOCK = threading.Lock()
_PROFILE = None


def _measure():
    import jax
    import jax.numpy as jnp
    dev = jax.devices()[0]
    platform = dev.platform
    if platform == 'cpu':
        # host buffers ARE device buffers; report a null-cost link
        return {'platform': 'cpu', 'latency_s': 0.0,
                'down_MBps': float('inf'), 'up_MBps': float('inf')}
    # one warm-up round trip (backend init, allocator warm-up)
    small = np.zeros(1024, np.uint8)
    _ = np.asarray(jax.device_put(small))
    # latency: median of 5 tiny round trips
    lats = []
    for _i in range(5):
        t0 = time.perf_counter()
        _ = np.asarray(jax.device_put(small))
        lats.append(time.perf_counter() - t0)
    latency = float(np.median(lats))
    # downlink: one 4 MB fetch (the render fetch granularity)
    buf = jax.device_put(np.zeros((2048, 2048), np.uint8))
    buf = jnp.add(buf, 0)  # materialize on device
    _ = np.asarray(buf)
    t0 = time.perf_counter()
    _ = np.asarray(buf)
    down = 4.194304 / max(time.perf_counter() - t0, 1e-9)
    # uplink: one 4 MB put (timed via a dependent tiny fetch)
    host = np.zeros((2048, 2048), np.uint8)
    t0 = time.perf_counter()
    d = jax.device_put(host)
    _ = np.asarray(jnp.sum(d, dtype=jnp.int32))
    up = 4.194304 / max(time.perf_counter() - t0, 1e-9)
    return {'platform': platform, 'latency_s': latency,
            'down_MBps': float(down), 'up_MBps': float(up)}


def link_profile(refresh=False):
    """Measured link profile dict: platform, latency_s, down_MBps,
    up_MBps. Cached per process; thread-safe. A failing probe raises:
    routing on made-up numbers would hide a broken device."""
    global _PROFILE
    with _LOCK:
        if _PROFILE is None or refresh:
            _PROFILE = _measure()
        return dict(_PROFILE)


def is_slow_link(profile=None):
    """True when per-transfer latency dominates small transfers (a
    remote or congested link): latency above ~5 ms means a 4 MB fetch pays >= 5%
    overhead per round trip and dispatch count is the lever."""
    p = profile or link_profile()
    return p['latency_s'] > 5e-3


def set_profile_for_testing(profile):
    """Test hook: inject a fake profile (or None to re-measure)."""
    global _PROFILE
    with _LOCK:
        _PROFILE = profile
