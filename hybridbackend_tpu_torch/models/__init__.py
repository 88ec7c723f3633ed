"""Feature extraction and ranking towers of the port."""

from hybridbackend_tpu_torch.models.layers import (
    MLP, Dense, Dice, LocalActivationUnit, attention_sequence_pooling)
from hybridbackend_tpu_torch.models.ranking import (
    DIN, DINSession, DLRM, StackedDCNv2)

__all__ = ['DIN', 'DINSession', 'DLRM', 'Dense', 'Dice',
           'LocalActivationUnit', 'MLP', 'StackedDCNv2',
           'attention_sequence_pooling']
