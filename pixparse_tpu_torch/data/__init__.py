from pixparse_tpu_torch.data.config import DataCfg, DatasetCfg, PreprocessCfg
from pixparse_tpu_torch.data.datasets_utils import (
    CustomVQADataset,
    SafeDataset,
    get_additional_tokens_from_dataset,
)
from pixparse_tpu_torch.data.loader import create_loader
from pixparse_tpu_torch.data.preprocess import (
    preprocess_ocr_anno,
    preprocess_text_anno,
    text_input_to_target,
)
from pixparse_tpu_torch.data.transforms import create_transforms
from pixparse_tpu_torch.data.wds import (
    LoaderBundle,
    braceexpand,
    create_doc_anno_pipe,
    create_image_text_pipe,
    create_wds_loader,
    expand_shards,
)
