"""Write ``tests/data/torch_orbax_zarr3/``: the tree of
``models_ckpt/gnn/best/f1`` (the relation GNN's best export at its full
width) restored by orbax and saved again by
``ocp.PyTreeCheckpointHandler(use_zarr3=True)``, an orbax checkpoint of
zarr v3 arrays in OCDBT, for the port's zarr v3 reader
(``tests/test_torch_orbax_zarr3.py``). Needs JAX and orbax:

    JAX_PLATFORMS=cpu python scripts/make_orbax_zarr3_fixture.py
"""
import os
import shutil
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(REPO, "models_ckpt", "gnn", "best", "f1")
OUT = os.path.join(REPO, "tests", "data", "torch_orbax_zarr3")


def main() -> int:
    import orbax.checkpoint as ocp
    tree = ocp.Checkpointer(ocp.PyTreeCheckpointHandler()).restore(SOURCE)
    shutil.rmtree(OUT, ignore_errors=True)
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    ocp.Checkpointer(ocp.PyTreeCheckpointHandler(use_zarr3=True)).save(OUT, tree)
    size = sum(os.path.getsize(os.path.join(d, f)) for d, _, names in os.walk(OUT)
               for f in names)
    print(f"{OUT}: {size} bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
