"""Unstructured mesh — placeholder.

Parity marker with the reference's ``preprocessing/mesh/unstructured.py``,
which is likewise a docstring-only placeholder (SURVEY §2.1).  This
framework targets structured grids; unstructured support would route through
a compressed-row adjacency + segment-sum formulation.
"""


class UnstructuredMesh:  # pragma: no cover - placeholder, like the reference
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "Unstructured meshes are not implemented (the reference ships a "
            "placeholder as well); use StructuredMesh."
        )
