"""The paper's baselines (counterparts of ``repro.baselines``): the
synchronous FedAvg, Oort, ClusterFL and Standalone, the asynchronous
FedAsyn and the semi-asynchronous FedSEA."""
from repro_torch.baselines.clusterfl import ClusterFL
from repro_torch.baselines.fedasyn import FedAsyn
from repro_torch.baselines.fedavg import FedAvg
from repro_torch.baselines.fedsea import FedSEA
from repro_torch.baselines.oort import Oort
from repro_torch.baselines.standalone import Standalone

__all__ = ["FedAvg", "FedAsyn", "FedSEA", "ClusterFL", "Oort", "Standalone"]
