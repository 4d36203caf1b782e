from repro_torch.data.synthetic import (  # noqa: F401
    TASK_TYPES,
    SyntheticInstructionDataset,
    TaskSpec,
    make_dataset_family,
)
from repro_torch.data.partition import (  # noqa: F401
    dirichlet_task_partition,
    specialist_partition,
)
from repro_torch.data.loader import (  # noqa: F401
    batch_iterator,
    client_batch,
    eval_batches,
    to_device,
)
from repro_torch.data.tokenizer import HashTokenizer  # noqa: F401
