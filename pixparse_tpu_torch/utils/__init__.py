from pixparse_tpu_torch.utils.json_utils import JSONParseEvaluator, json2token, token2json
from pixparse_tpu_torch.utils.metrics import (
    average_normalized_levenshtein_similarity,
    normalized_levenshtein,
    similarity_score,
)
from pixparse_tpu_torch.utils.name_utils import clean_name, natural_key
from pixparse_tpu_torch.utils.text_metrics import cer_metric, get_cer_wer_metrics, wer_metric
from pixparse_tpu_torch.utils.tree_edit import TreeNode, tree_edit_distance
