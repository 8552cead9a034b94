"""Every public name of the JAX package has its counterpart in the port.

A static check (``ast`` only, neither package imported): each public
top-level function and class, and each public method, of every
``pydnmfk_tpu/**.py`` has a same-named twin in the port's file at the same
path (for a method: a method, property or attribute of the same class), or
stands in ``COUNTERPARTS`` with the port's name for it or the ROADMAP
"Not to port" line that covers it. Every ``examples/*.py`` has its port in
``pydnmfk_tpu_torch/examples/``.
"""
import ast
import glob
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX, PORT = "pydnmfk_tpu", "pydnmfk_tpu_torch"

# the ROADMAP "Not to port" lines that cover JAX-only machinery
NOT_TO_PORT = {
    "pallas": "the Pallas modules (ops/pallas_kernels.py, ops/pallas_ell.py) "
              "with their dispatch switches (use_pallas, use_pallas_ell, "
              "ell_pallas_disabled, pallas_available), fit_tile and "
              "matmul_compute_dtype: the CUDA kernels' wrappers dispatch "
              "and mask ragged tiles",
    "pytree": "JAX pytree registration (tree_flatten / tree_unflatten)",
    "sharding": "jax.sharding: the specs, shardings and put_* of "
                "GridContext, make_grid_mesh, single_device_mesh and "
                "host_local; a rank of the port holds its own tensors",
    "xla": "the XLA compilation cache (config.enable_compilation_cache) "
           "and JAX's x64 switch (config.ensure_precision_enabled): torch "
           "takes f64 as a dtype",
}

# "file::name" of the JAX package -> ("port", "file::name") of its
# counterpart under another name, or ("not", a NOT_TO_PORT key)
COUNTERPARTS = {
    "config.py::enable_compilation_cache": ("not", "xla"),
    "config.py::ensure_precision_enabled": ("not", "xla"),
    # JAX's RNG keys: the port keys a member's generator by (seed, member,
    # stream)
    "models/sampler.py::member_keys": (
        "port", "models/sampler.py::member_generator"),
    "models/sampler.py::member_keys_at": (
        "port", "models/sampler.py::member_generator"),
    "models/sampler.py::member_noise_key": (
        "port", "models/sampler.py::member_generator"),
    "models/sampler.py::sample_one": (
        "port", "models/sampler.py::sample_member"),
    "ops/ell.py::EllSparse.tree_flatten": ("not", "pytree"),
    "ops/ell.py::EllSparse.tree_unflatten": ("not", "pytree"),
    "ops/ell.py::ell_pallas_disabled": ("not", "pallas"),
    # the shard-mapped ELL: each rank packs its block into an EllSparse
    # (grid_ell_pack) and the grid products sum the block's
    "ops/ell.py::GridEllSparse": ("port", "ops/ell.py::EllSparse"),
    "ops/ell.py::GridEllSparse.astype": (
        "port", "ops/ell.py::EllSparse.astype"),
    "ops/ell.py::GridEllSparse.dtype": ("port", "ops/ell.py::EllSparse.dtype"),
    "ops/ell.py::GridEllSparse.tree_flatten": ("not", "pytree"),
    "ops/ell.py::GridEllSparse.tree_unflatten": ("not", "pytree"),
    "ops/ell.py::gell_a_ht": ("port", "ops/linalg.py::matmul_AHT"),
    "ops/ell.py::gell_wt_a": ("port", "ops/linalg.py::matmul_WTA"),
    "ops/ell.py::gell_kl_uht": ("port", "ops/ell.py::ell_kl_uht"),
    "ops/ell.py::gell_kl_wtu": ("port", "ops/ell.py::ell_kl_wtu"),
    "ops/ell.py::gell_col_sqsum": ("port", "ops/ell.py::ell_col_sqsum"),
    "ops/ell.py::gell_sqnorm": ("port", "ops/linalg.py::sqnorm"),
    "ops/pallas_ell.py::ell_gather_product": (
        "port", "ops/ell_gather.py::ell_gather_product"),
    "ops/pallas_ell.py::table_fits_vmem": (
        "port", "ops/ell_gather.py::slab_plan"),
    "ops/pallas_ell.py::use_pallas_ell": ("not", "pallas"),
    "ops/pallas_kernels.py::kl_uht_pallas": ("port", "ops/kl.py::kl_uht"),
    "ops/pallas_kernels.py::kl_wtu_pallas": ("port", "ops/kl.py::kl_wtu"),
    "ops/pallas_kernels.py::fit_tile": ("not", "pallas"),
    "ops/pallas_kernels.py::matmul_compute_dtype": ("not", "pallas"),
    "ops/pallas_kernels.py::pallas_available": ("not", "pallas"),
    # the shard-mapped sparse formats: a rank's block in a SparseGridInput,
    # summed over the grid by the linalg products
    "ops/sparse.py::GridShardedSparse": (
        "port", "ops/sparse.py::SparseGridInput"),
    "ops/sparse.py::GridShardedSparse.dtype": (
        "port", "ops/sparse.py::SparseGridInput.dtype"),
    "ops/sparse.py::GridShardedSparse.nse": (
        "port", "ops/sparse.py::SparseGridInput.nse"),
    "ops/sparse.py::GridShardedSparse.tree_flatten": ("not", "pytree"),
    "ops/sparse.py::GridShardedSparse.tree_unflatten": ("not", "pytree"),
    "ops/sparse.py::SparseGridInput.data": (
        "port", "ops/sparse.py::SparseGridInput.flat"),
    "ops/sparse.py::shard_sparse_for_grid": (
        "port", "ops/sparse.py::grid_format"),
    "ops/sparse.py::a_ht_bcoo": ("port", "ops/sparse.py::a_ht_triplet"),
    "ops/sparse.py::wt_a_bcoo": ("port", "ops/sparse.py::wt_a_triplet"),
    "ops/sparse.py::rs_a_ht": ("port", "ops/linalg.py::matmul_AHT"),
    "ops/sparse.py::rs_wt_a": ("port", "ops/linalg.py::matmul_WTA"),
    "ops/sparse.py::rs_kl_uht": ("port", "ops/sparse.py::kl_uht_sparse"),
    "ops/sparse.py::rs_kl_wtu": ("port", "ops/sparse.py::kl_wtu_sparse"),
    "ops/sparse.py::rs_col_sqsum": ("port", "ops/sparse.py::col_sqsum"),
    "parallel/mesh.py::GridContext.n_devices": (
        "port", "parallel/mesh.py::GridContext.world_size"),
    "parallel/mesh.py::GridContext.put_A": ("not", "sharding"),
    "parallel/mesh.py::GridContext.put_H": ("not", "sharding"),
    "parallel/mesh.py::GridContext.put_W": ("not", "sharding"),
    "parallel/mesh.py::GridContext.sharding": ("not", "sharding"),
    "parallel/mesh.py::GridContext.sharding_A": ("not", "sharding"),
    "parallel/mesh.py::GridContext.sharding_H": ("not", "sharding"),
    "parallel/mesh.py::GridContext.sharding_W": ("not", "sharding"),
    "parallel/mesh.py::GridContext.spec_A": ("not", "sharding"),
    "parallel/mesh.py::GridContext.spec_A_batched": ("not", "sharding"),
    "parallel/mesh.py::GridContext.spec_H": ("not", "sharding"),
    "parallel/mesh.py::GridContext.spec_H_batched": ("not", "sharding"),
    "parallel/mesh.py::GridContext.spec_W": ("not", "sharding"),
    "parallel/mesh.py::GridContext.spec_W_batched": ("not", "sharding"),
    "parallel/mesh.py::GridContext.spec_replicated": ("not", "sharding"),
    "parallel/mesh.py::make_grid_mesh": ("not", "sharding"),
    "parallel/mesh.py::single_device_mesh": ("not", "sharding"),
    "parallel/mesh.py::host_local": ("not", "sharding"),
    "parallel/mesh.py::grid_context": ("port", "parallel/mesh.py::initialize"),
    "parallel/mesh.py::initialize_multihost": (
        "port", "parallel/mesh.py::initialize"),
    "utils/io.py::DataReader.read_sparse_grid": (
        "port", "utils/io.py::DataReader.read"),
}


def _names(path):
    """Public top-level functions and classes of a module, and each public
    class's members: methods, properties, class attributes and the
    attributes its methods set on ``self``; None where there is no file."""
    if not os.path.exists(path):
        return None
    with open(path) as f:
        tree = ast.parse(f.read())
    out = set()
    for node in tree.body:
        if not isinstance(node, (ast.FunctionDef, ast.ClassDef)) or \
                node.name.startswith("_"):
            continue
        out.add(node.name)
        if not isinstance(node, ast.ClassDef):
            continue
        for sub in node.body:
            if isinstance(sub, ast.FunctionDef):
                out.add(f"{node.name}.{sub.name}")
                for x in ast.walk(sub):
                    if (isinstance(x, ast.Attribute)
                            and isinstance(x.ctx, ast.Store)
                            and isinstance(x.value, ast.Name)
                            and x.value.id == "self"):
                        out.add(f"{node.name}.{x.attr}")
            elif isinstance(sub, ast.AnnAssign) and isinstance(sub.target,
                                                               ast.Name):
                out.add(f"{node.name}.{sub.target.id}")
            elif isinstance(sub, ast.Assign):
                out.update(f"{node.name}.{t.id}" for t in sub.targets
                           if isinstance(t, ast.Name))
    return {n for n in out if not n.split(".")[-1].startswith("_")}


def _jax_files():
    return sorted(os.path.relpath(p, os.path.join(REPO, JAX)) for p in
                  glob.glob(os.path.join(REPO, JAX, "**", "*.py"),
                            recursive=True))


def _public(rel):
    """The JAX file's public names that need a counterpart: those of its
    classes' members that are methods (JAX's own attributes are state)."""
    path = os.path.join(REPO, JAX, rel)
    with open(path) as f:
        tree = ast.parse(f.read())
    out = set()
    for node in tree.body:
        if not isinstance(node, (ast.FunctionDef, ast.ClassDef)) or \
                node.name.startswith("_"):
            continue
        out.add(node.name)
        if isinstance(node, ast.ClassDef):
            out.update(f"{node.name}.{sub.name}" for sub in node.body
                       if isinstance(sub, ast.FunctionDef)
                       and not sub.name.startswith("_"))
    return out


def _missing():
    """{'file::name'} of the JAX package with no same-named twin."""
    missing = set()
    for rel in _jax_files():
        port = _names(os.path.join(REPO, PORT, rel)) or set()
        missing.update(f"{rel}::{name}" for name in _public(rel) - port)
    return missing


def test_every_public_name_has_a_counterpart():
    gaps = sorted(_missing() - set(COUNTERPARTS))
    assert not gaps, (f"JAX public names with no twin in the port's file "
                      f"at the same path and no COUNTERPARTS row: {gaps}")


def test_every_row_is_needed():
    """A row whose JAX name has a twin (or is gone) must go."""
    stale = sorted(set(COUNTERPARTS) - _missing())
    assert not stale, f"COUNTERPARTS rows with a same-named twin: {stale}"


@pytest.mark.parametrize("key", sorted(COUNTERPARTS))
def test_each_row_names_a_port_name_or_a_not_to_port_line(key):
    kind, what = COUNTERPARTS[key]
    if kind == "not":
        assert what in NOT_TO_PORT
        return
    assert kind == "port"
    rel, name = what.split("::")
    names = _names(os.path.join(REPO, PORT, rel))
    assert names is not None and name in names, (
        f"{key}: the port has no {what}")


def test_every_example_has_its_port():
    jax_examples = sorted(os.path.basename(p) for p in
                          glob.glob(os.path.join(REPO, "examples", "*.py")))
    assert len(jax_examples) == 9
    for name in jax_examples:
        path = os.path.join(REPO, PORT, "examples", name)
        assert os.path.exists(path), f"examples/{name} has no port"
        assert "main" in _names(path), f"{path} has no main"


def test_the_port_never_imports_jax_or_the_jax_package():
    """No module of the port, examples included, imports jax or
    pydnmfk_tpu (by ast, so a string or comment does not count)."""
    for path in glob.glob(os.path.join(REPO, PORT, "**", "*.py"),
                          recursive=True):
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            mods = ([a.name for a in node.names]
                    if isinstance(node, ast.Import) else
                    [node.module or ""] if isinstance(node, ast.ImportFrom)
                    and node.level == 0 else [])
            for mod in mods:
                top = mod.split(".")[0]
                assert top not in ("jax", "jaxlib", JAX), (path, mod)
