from pixparse_tpu_torch.data.config import DataCfg, DatasetCfg, PreprocessCfg
from pixparse_tpu_torch.data.loader import create_loader
from pixparse_tpu_torch.data.preprocess import preprocess_ocr_anno, preprocess_text_anno
from pixparse_tpu_torch.data.transforms import create_transforms
