"""The plain reference against the port on the smoke configurations of
both families through one round, the port on its plain kernels (CPU)."""
import pytest
import torch

from conftest import cells


def one_round(root, cell_name, seed):
    from portbench import feed, harness, registry
    from portbench.reference import common as C
    from portbench.reference import federated
    from repro_torch.fl.loop import run_federated
    cell = registry.load_cell(cell_name, root)
    port, dep, traffic = cell.config["port"], cell.config["deployment"], \
        cell.traffic
    fam = registry.family(port["family"], root)
    data_seed, weight_seed, loader_seed, sim_seed = feed.seeds(seed, 4)
    clients, test = feed.make(traffic, port["vocab_size"], data_seed, 1)
    start = fam.init(port, weight_seed, "cpu")
    mcfg = harness.port_config(port)
    fl = harness.fl_config(dep, traffic, 1, loader_seed)
    sim, transport = harness.links(mcfg, fl, traffic["clients"],
                                   traffic["seq"], sim_seed)
    with harness.SetupProbe([p for p, _ in C.leaf_paths(start)]) as probe:
        hist = run_federated(mcfg, clients, test, fl, sim=sim,
                             transport=transport, init_params=start,
                             device="cpu")
    got = harness.program_numbers(hist, probe, start)
    want = federated.run(fam, port, dep, traffic, start, clients, test,
                         loader_seed, 1)
    return got, want


@pytest.mark.parametrize("cell", cells())
@pytest.mark.parametrize("seed", [11, 2 ** 33 + 5])
def test_reference_follows_the_port(smoke_root, cell, seed):
    from portbench import check
    got, want = one_round(smoke_root, cell, seed)
    assert len(got["losses"]) == len(want["losses"]) == 6
    # the same fp32 operations in another order: round-off apart
    assert check.value_gap(got["losses"], want["losses"]) <= 1e-6
    assert check.value_gap(got["evals"], want["evals"]) <= 1e-6
    assert set(got["update0"]) == set(want["update0"])
    # the update passes top-k and the int8 wire: a lane's round-off can
    # flip a keep decision or an int8 code, a step of ~1/127 of its
    # block's largest delta, which at smoke size moves a leaf's norm by
    # up to a few 1e-4 of the median leaf's
    assert check.leaf_gap(got["update0"], want["update0"],
                          want["update0"]) <= 1e-3
    # and the round moved every leaf
    assert min(want["update0"].values()) > 0


def test_the_reference_imports_nothing_of_the_port():
    import ast
    from conftest import ROOT
    for path in (ROOT / "portbench" / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""]
                     if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert n.split(".")[0] not in ("repro_torch", "repro",
                                               "jax"), (path, n)


def test_sgd_step_matches_the_formula(smoke_root):
    """One client, one step: the reference's new weights are p - lr * g
    of its own loss's gradient."""
    from portbench import feed, registry
    from portbench.reference import common as C
    cell = registry.load_cell(cells()[0], smoke_root)
    port = cell.config["port"]
    fam = registry.family(port["family"], smoke_root)
    p = fam.init(port, 3, "cpu")
    clients, _ = feed.make(cell.traffic, port["vocab_size"], 4, 1)
    tok = torch.from_numpy(clients[0]["tokens"][:1])
    lab = torch.from_numpy(clients[0]["labels"][:1])
    leaves = [t.requires_grad_() for _, t in C.leaf_paths(p)]
    loss = fam.loss(port, p, tok, lab, 1, True)
    grads = torch.autograd.grad(loss, leaves)
    assert all(torch.isfinite(g).all() for g in grads)
    assert any(float(g.abs().max()) > 0 for g in grads)
