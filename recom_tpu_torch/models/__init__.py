from recom_tpu_torch.models.criteo import (  # noqa: F401
    CRITEO_VOCABS,
    make_criteo_dlrm,
    read_criteo_tsv,
)
from recom_tpu_torch.models.postpool import (  # noqa: F401
    make_every_post_model,
    make_matmul_model,
    make_post_model,
    make_softmax_mul_model,
)
from recom_tpu_torch.models.synthetic import (  # noqa: F401
    make_dlrm_model,
    make_microbenchmark_model,
    make_model_e,
    make_model_f,
    make_random_batch,
)
