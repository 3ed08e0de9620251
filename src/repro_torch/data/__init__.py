from repro_torch.data.datasets import PromptDataset, synthetic_instruction_prompts
from repro_torch.data.tokenizer import ByteTokenizer

__all__ = ["ByteTokenizer", "PromptDataset", "synthetic_instruction_prompts"]
