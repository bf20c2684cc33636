"""Worker script for the port's ``Job`` launch tests
(``tests/test_torch_job.py``), run once a rank by ``job_deployment.Job``.

Each process joins the gloo group from the environment ``Job`` rendered
(``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
``LOCAL_RANK``), with one thread, and then:

* ``DK_MODE=sync``: trains ``SynchronousDistributedTrainer`` on the small
  MLP (``DK_INIT``: its initial weights, an ``.npz``) at two workers, one
  a rank, and writes ``$DK_OUT/proc<rank>.npz`` (the params) and
  ``proc<rank>.json`` (the history);
* ``DK_MODE=ps``: is DynSGD worker ``RANK`` against the parameter server
  at ``DKTPU_PS_ENDPOINT``: join, then ``DK_ROUNDS`` rounds of pull, two
  local steps and one commit. After a barrier rank 0 retransmits its last
  commit under the same seq and reads the server's counters into
  ``proc0.json``.
"""

import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def _sync(out: str, rank: int) -> None:
    import torch_rank_workers as RW

    init = dict(np.load(os.environ["DK_INIT"]))
    kw = dict(worker_optimizer="sgd", batch_size=4, steps_per_program=2,
              learning_rate=0.1, num_workers=2)
    res = RW.train_case(dict(trainer="SynchronousDistributedTrainer",
                             kind="mlp", kw=kw, rows=2 * 2 * 4 * 2,
                             weights=init))
    np.savez(os.path.join(out, f"proc{rank}.npz"), **res["params"])
    with open(os.path.join(out, f"proc{rank}.json"), "w") as f:
        json.dump({"history": res["history"].tolist(),
                   "world": res["world"]}, f)


def _ps(out: str, rank: int) -> None:
    import torch_rank_workers as RW
    from distkeras_tpu_torch.netps import PSClient
    from distkeras_tpu_torch.ops import collectives
    from distkeras_tpu_torch.ops.losses import get_loss
    from distkeras_tpu_torch.ops.optimizers import get_optimizer
    from distkeras_tpu_torch.runtime import config
    from distkeras_tpu_torch.workers import derive_seed, make_local_loop

    model = RW.build_model("mlp")
    keys = list(model.params)
    tx = get_optimizer("sgd", 0.1)
    loop = make_local_loop(model.module,
                           get_loss("sparse_categorical_crossentropy"), tx)
    rounds = int(os.environ["DK_ROUNDS"])
    cols = RW.columns("mlp", rounds * 2 * 4, seed=rank)
    xs = torch.as_tensor(cols["features"]).reshape(rounds, 2, 4, 784)
    ys = torch.as_tensor(cols["label"]).reshape(rounds, 2, 4)
    client = PSClient(config.env_str("DKTPU_PS_ENDPOINT"), worker_id=rank)
    client.join(init=[model.params[k].numpy() for k in keys])
    results = []
    for r in range(rounds):
        arrays, counter = client.pull()
        pulled = {k: torch.as_tensor(np.array(a)) for k, a in
                  zip(keys, arrays)}
        new, _, _, _ = loop(pulled, tx.init(pulled), xs[r], ys[r],
                            rng=derive_seed(0, rank, r))
        delta = [(new[k] - pulled[k]).numpy() for k in keys]
        res = client.commit(delta, counter)
        results.append([res.applied, res.duplicate, res.evicted])
    collectives.barrier()
    report = {"results": results}
    if rank == 0:
        report["before"] = {k: client.stats()[k]
                            for k in ("updates", "commits_total")}
        again = client.commit(delta, counter, seq=client._seq)
        report["retransmit"] = [again.applied, again.duplicate]
        report["after"] = {k: client.stats()[k]
                           for k in ("updates", "commits_total")}
        report["fold_backend"] = client.stats()["fold_backend"]
    collectives.barrier()
    client.close()
    with open(os.path.join(out, f"proc{rank}.json"), "w") as f:
        json.dump(report, f)


def main() -> None:
    torch.set_num_threads(1)
    from distkeras_tpu_torch.runtime import mesh

    mesh.distributed_initialize(device="cpu", timeout=120)
    out, rank = os.environ["DK_OUT"], mesh.rank()
    try:
        if os.environ.get("DK_MODE", "sync") == "sync":
            _sync(out, rank)
        else:
            _ps(out, rank)
    finally:
        mesh.distributed_shutdown()


if __name__ == "__main__":
    main()
