from .core import (
    Proposal,
    RandomWalkProposal,
    StaticProposal,
    SymmetricRandomWalkProposal,
    SymmetricStaticProposal,
    as_static_proposal_tree,
    is_proposal,
    logratio_proposal_density,
    propose,
    propose_initial,
    q,
)

__all__ = [
    "Proposal", "RandomWalkProposal", "StaticProposal",
    "SymmetricRandomWalkProposal", "SymmetricStaticProposal",
    "as_static_proposal_tree", "is_proposal",
    "logratio_proposal_density", "propose", "propose_initial", "q",
]
