import os

# Tests run on a virtual 8-device CPU mesh — the analogue of the reference's
# fake backends (SURVEY.md §4): multi-device sharding is validated without
# real cards. The platform is pinned through jax.config below. The persistent
# compile cache stays off (here and in subprocesses) so that no test run
# writes compiled programs into the checkout.
os.environ.pop("JAX_PLATFORMS", None)
os.environ["JAX_ENABLE_COMPILATION_CACHE"] = "false"
_flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = _flags + " --xla_force_host_platform_device_count=8"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
