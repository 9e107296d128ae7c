# Port copy of recom_tpu/importers/__init__.py: only the package name in
# imports differs, and it also exports import_params and
# load_checkpoint_tables.
from recom_tpu_torch.importers.tf_graph import (  # noqa: F401
    import_params,
    import_tf_graphdef,
    import_tf_saved_model,
    load_checkpoint_tables,
)
