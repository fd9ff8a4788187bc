"""How far the port's data-parallel step parts from the reference's, step
by step (a diagnostic, not a test; tests/test_torch_dp_train.py holds the
bars). From the reference's init of one smoke config and the batches of
tests/torch_dp_helpers.py it runs, on the CPU:

  * ref_mesh: the reference's train step, its batch sharded over a
    (data = 2, model = 1) mesh of forced host devices, the mesh active;
  * ref_acc2 / ref_acc1: the reference's single-device step at grad_accum
    2 / 1;
  * port_acc2: the port's grad_accum = 2 step (bitwise its data = 2 step:
    tests/test_torch_dp_train.py);

and prints each run's (loss, grad norm) a step and, for pairs of runs,
the four largest first-moment gaps after the last step, each over its
leaf's max abs.

  PYTHONPATH=src:tests JAX_PLATFORMS=cpu python tests/torch_dp_gap.py \\
      qwen2-moe-a2.7b 2
"""
import contextlib
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from jax.sharding import NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

import torch_dp_helpers as h  # noqa: E402
from repro.configs import SMOKES  # noqa: E402
from repro.distributed import sharding as shd  # noqa: E402
from repro.models import get_model  # noqa: E402
from repro.training.optimizer import OptConfig, init_opt_state  # noqa: E402
from repro.training.train import make_train_step  # noqa: E402
from repro_torch.configs import SMOKES as PORT_SMOKES  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402


def main(name: str, steps: int) -> None:
    torch.set_num_threads(1)
    cfg, pcfg = SMOKES[name], PORT_SMOKES[name]
    api = get_model(cfg)
    p0 = jax.tree_util.tree_map(np.asarray, api.init(jax.random.PRNGKey(0), cfg))
    batches = h.token_batches(cfg, 0, steps, h.B, h.S)
    oc = h.OPT
    opt_cfg = OptConfig(lr=oc.lr, warmup_steps=oc.warmup_steps, total_steps=oc.total_steps)
    mesh = jax.make_mesh((2, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    port = lambda tree: h.flat(params_from_numpy(
        jax.tree_util.tree_map(np.asarray, tree), pcfg, "cpu"))

    def ref_run(on_mesh: bool, accum: int):
        params = jax.tree_util.tree_map(jnp.asarray, p0)
        opt = init_opt_state(params)
        step = jax.jit(make_train_step(api, cfg, opt_cfg, accum),
                       compiler_options={"xla_allow_excess_precision": False})
        if on_mesh:
            shd.set_active_mesh(mesh)
            params, opt = jax.device_put((params, opt), NamedSharding(mesh, P()))
        metrics = []
        try:
            with mesh if on_mesh else contextlib.nullcontext():
                for b in batches:
                    specs = shd.batch_specs(b, mesh) if on_mesh else {}
                    b = {k: jax.device_put(jnp.asarray(v), NamedSharding(mesh, specs[k]))
                         if on_mesh else jnp.asarray(v) for k, v in b.items()}
                    params, opt, m = step(params, opt, b)
                    metrics.append((float(m["loss"]), float(m["grad_norm"])))
        finally:
            shd.set_active_mesh(None)
        return metrics, port(opt.mu)

    d = os.path.join(os.environ.get("TMPDIR", "/tmp"), f"torch_dp_gap_{os.getpid()}")
    os.makedirs(d, exist_ok=True)
    init = os.path.join(d, "init.pt")
    torch.save(params_from_numpy(p0, pcfg, "cpu"), init)
    try:
        got = h.run_steps(name, batches, grad_accum=2, init=init)
    finally:
        os.remove(init)
        os.rmdir(d)
    runs = {"ref_mesh": ref_run(True, 1), "ref_acc2": ref_run(False, 2),
            "ref_acc1": ref_run(False, 1),
            "port_acc2": ([(float(m["loss"]), float(m["grad_norm"]))
                           for m in got["metrics"]], got["mu"])}
    for k, (metrics, _) in runs.items():
        print(k, metrics)
    for a, b in (("port_acc2", "ref_mesh"), ("port_acc2", "ref_acc2"),
                 ("ref_acc2", "ref_mesh"), ("ref_acc1", "ref_mesh")):
        mu_a, mu_b = runs[a][1], runs[b][1]
        gaps = sorted(((float((mu_a[k] - w).abs().max()) / float(w.abs().max()), k)
                       for k, w in mu_b.items()), reverse=True)[:4]
        print(a, "vs", b, [(k, g) for g, k in gaps])


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
