from repro_torch.core.flow import FlowQueue, QueueState
from repro_torch.core.index import SchedulerIndex
from repro_torch.core.mqfq import MQFQ, SFQ, MQFQSticky
from repro_torch.core.policies import FCFS, SJF, Batch, EEVDF, make_policy
from repro_torch.core.policy_base import Policy
from repro_torch.core.tokens import ConcurrencyController
from repro_torch.core.fairness import FairnessTracker
