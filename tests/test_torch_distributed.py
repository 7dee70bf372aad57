"""The port's process-group route: two processes joined by gloo, each
holding 4 CPU shards of one 8-shard mesh, so every collective of the
tiered selection crosses the process boundary. Merges must equal
single-device training (and the JAX package's, which the test process
computes), and only process 0 may write resources (the JAX package's
``tests/test_distributed.py``).

Run as a script, this file is one worker:
``python tests/test_torch_distributed.py <rank> <world> <port> <outdir>``.
"""
import json
import os
import socket
import subprocess
import sys

CORPUS = [
    "Litwo! Ojczyzno moja! ty jesteś jak zdrowie.",
    "Ile cię trzeba cenić, ten tylko się dowie,",
    "Kto cię stracił. Dziś piękność twą w całej ozdobie",
    "Widzę i opisuję, bo tęsknię po tobie.",
]


def worker(rank: int, world: int, port: str, outdir: str) -> None:
    import torch
    torch.set_num_threads(1)
    from subword_tokenizers_tpu_torch import FastWP, NaiveBPE, NaiveWP
    from subword_tokenizers_tpu_torch.parallel import distributed
    from subword_tokenizers_tpu_torch.parallel.mesh import make_data_mesh

    distributed.initialize(f"localhost:{port}", num_processes=world,
                           process_id=rank, device="cpu")
    distributed.initialize(f"localhost:{port}", num_processes=world,
                           process_id=rank, device="cpu")  # a no-op
    assert distributed.process_count() == world
    assert distributed.is_coordinator() == (rank == 0)
    mesh = make_data_mesh(devices=["cpu"] * 4)
    assert (mesh.size, mesh.first) == (4 * world, 4 * rank)

    tok = NaiveBPE(mesh=mesh, device="cpu")
    tok.train(CORPUS, 120)
    single = NaiveBPE(device="cpu")
    single.train(CORPUS, 120)
    assert tok.merges_list == single.merges_list, "BPE merges diverged"
    assert tok.corpus_as_symbols == single.corpus_as_symbols
    wp = NaiveWP(mesh=mesh, device="cpu")
    wp.train(CORPUS, 140)
    wp_single = NaiveWP(device="cpu")
    wp_single.train(CORPUS, 140)
    assert wp._merge_log == wp_single._merge_log, "WordPiece diverged"

    # fetch_global: every process gets every shard's rows
    rows = [torch.full((2, 3), 4 * rank + i) for i in range(4)]
    got = distributed.fetch_global(rows, mesh)
    assert got.shape == (16 * world // 2, 3)
    assert got[:, 0].tolist() == [s for s in range(4 * world)
                                  for _ in range(2)]

    # FastWP's sharded encode has no process-group route
    fw = FastWP(mesh=mesh, device="cpu")
    fw.train(CORPUS, 140)
    try:
        fw.tokenize_batch(CORPUS)
        refused = False
    except RuntimeError as e:
        refused = "process-group mesh" in str(e)

    if distributed.is_coordinator():
        tok.save_resources(os.path.join(outdir, "resources"))
    with open(os.path.join(outdir, f"proc{rank}.json"), "w") as f:
        json.dump({"wrote": distributed.is_coordinator(),
                   "merges": tok.merges_list, "wp": wp._merge_log,
                   "refused": refused, "stats": tok._sel_stats}, f)
    torch.distributed.destroy_process_group()


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_training(tmp_path):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               str(rank), "2", port, str(tmp_path)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for rank in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out}"
    r0, r1 = ([json.load(open(tmp_path / f"proc{r}.json")) for r in (0, 1)])
    assert r0["wrote"] and not r1["wrote"]
    assert r0["merges"] == r1["merges"] and len(r0["merges"]) > 40
    assert r0["wp"] == r1["wp"] and r0["refused"] and r1["refused"]
    assert r0["stats"] == r1["stats"]

    from subword_tokenizers_tpu import NaiveBPE as JaxNaiveBPE
    from subword_tokenizers_tpu import NaiveWP as JaxNaiveWP
    jax_tok = JaxNaiveBPE()
    jax_tok.train(CORPUS, 120)
    assert [tuple(m) for m in r0["merges"]] == jax_tok.merges_list
    jax_wp = JaxNaiveWP()
    jax_wp.train(CORPUS, 140)
    assert [tuple(m) for m in r0["wp"]] == jax_wp._merge_log
    from subword_tokenizers_tpu_torch import NaiveBPE
    loaded = NaiveBPE(device="cpu")
    loaded.load_resources(str(tmp_path / "resources"), strict=True)
    assert loaded.merges_list == jax_tok.merges_list


if __name__ == "__main__":
    worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
