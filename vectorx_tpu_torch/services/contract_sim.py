"""Executable Python model of the VectorX contract and a mock proof gateway.

``VectorXSim`` mirrors ``contracts/src/VectorX.sol`` statement for
statement (the same storage maps, the same byte-level request/commit ABI
from ``circuits/abi.py``, the same revert conditions, the same events), and
``MockProofGateway`` implements the ``IProofGateway`` semantics:
requestCall records a pending request; ``fulfill`` attaches a proven output
to exactly one (functionId, input) pair; verifiedCall returns it or
reverts. Together they drive request -> prove -> fulfil -> commit without
a chain.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

from ..circuits import abi
from ..utils.keccak import keccak256


def selector(signature: str) -> bytes:
    """First 4 bytes of keccak256 of the canonical signature."""
    return keccak256(signature.encode())[:4]


# canonical ABI signatures of the contract's callback entrypoints
# (contracts/src/VectorX.sol)
COMMIT_HEADER_RANGE_SIG = "commitHeaderRange(uint64,uint32)"
ROTATE_SIG = "rotate(uint64)"
CALLBACK_GAS_LIMIT = 500_000        # VectorX.sol:66


def _abi_word(v: int) -> bytes:
    return v.to_bytes(32, "big")


def encode_commit_header_range_call(authority_set_id: int,
                                    target_block: int) -> bytes:
    """abi.encodeWithSelector(commitHeaderRange.selector, id, target)."""
    return (selector(COMMIT_HEADER_RANGE_SIG) + _abi_word(authority_set_id)
            + _abi_word(target_block))


def encode_rotate_call(authority_set_id: int) -> bytes:
    return selector(ROTATE_SIG) + _abi_word(authority_set_id)


class Revert(Exception):
    """A require/revert in the simulated EVM call."""


@dataclass
class Request:
    function_id: bytes
    input: bytes
    callback_contract: "VectorXSim"
    entry_calldata: bytes
    gas_limit: int


class MockProofGateway:
    """IProofGateway semantics: requestCall records; verifiedCall returns
    the fulfilled output for exactly (functionId, input) or reverts."""

    def __init__(self):
        self.requests: List[Request] = []
        self._proven: Dict[Tuple[bytes, bytes], bytes] = {}

    # -- IProofGateway ----------------------------------------------------
    def requestCall(self, function_id: bytes, input_: bytes,
                    callback_contract: "VectorXSim", entry_calldata: bytes,
                    gas_limit: int) -> None:
        self.requests.append(Request(function_id, input_, callback_contract,
                                     entry_calldata, gas_limit))

    def verifiedCall(self, function_id: bytes, input_: bytes) -> bytes:
        key = (function_id, input_)
        if key not in self._proven:
            raise Revert("gateway: no verified output for this call")
        return self._proven[key]

    # -- operator side ----------------------------------------------------
    def fulfill(self, function_id: bytes, input_: bytes,
                output: bytes) -> None:
        """Record a proven (input -> output) pair for a function id."""
        self._proven[(function_id, input_)] = output

    def fulfill_request(self, req: Request, output: bytes) -> None:
        """Fulfill a recorded request and invoke its callback, the
        gateway's request→callback flow (IProofGateway.requestCall docs)."""
        self.fulfill(req.function_id, req.input, output)
        req.callback_contract.call(req.entry_calldata)


@dataclass
class Event:
    name: str
    args: dict


@dataclass
class VectorXSim:
    """Python mirror of contracts/src/VectorX.sol (same storage names)."""

    guardian: str
    gateway: MockProofGateway
    header_range_function_id: bytes
    rotate_function_id: bytes
    header_range_commitment_tree_size: int

    frozen: bool = False
    latest_block: int = 0
    latest_authority_set_id: int = 0
    block_height_to_header_hash: Dict[int, bytes] = field(default_factory=dict)
    authority_set_id_to_hash: Dict[int, bytes] = field(default_factory=dict)
    data_root_commitments: Dict[bytes, bytes] = field(default_factory=dict)
    state_root_commitments: Dict[bytes, bytes] = field(default_factory=dict)
    range_start_blocks: Dict[bytes, int] = field(default_factory=dict)
    events: List[Event] = field(default_factory=list)

    ZERO32 = bytes(32)

    @classmethod
    def deploy(cls, guardian: str, gateway: MockProofGateway, height: int,
               header: bytes, authority_set_id: int,
               authority_set_hash: bytes,
               header_range_function_id: bytes = b"\x01" * 32,
               rotate_function_id: bytes = b"\x02" * 32,
               tree_size: int = 256) -> "VectorXSim":
        sim = cls(guardian=guardian, gateway=gateway,
                  header_range_function_id=header_range_function_id,
                  rotate_function_id=rotate_function_id,
                  header_range_commitment_tree_size=tree_size)
        sim.latest_block = height
        sim.latest_authority_set_id = authority_set_id
        sim.block_height_to_header_hash[height] = header
        sim.authority_set_id_to_hash[authority_set_id] = authority_set_hash
        return sim

    # -- calldata dispatch (the gateway callback path) ---------------------

    def call(self, calldata: bytes) -> None:
        sel, args = calldata[:4], calldata[4:]
        if sel == selector(COMMIT_HEADER_RANGE_SIG):
            self.commit_header_range(int.from_bytes(args[0:32], "big"),
                                     int.from_bytes(args[32:64], "big"))
        elif sel == selector(ROTATE_SIG):
            self.rotate(int.from_bytes(args[0:32], "big"))
        else:
            raise Revert("unknown selector")

    # -- guardian ops ------------------------------------------------------

    def _only_guardian(self, sender: str) -> None:
        if sender != self.guardian:
            raise Revert("NotGuardian")

    def update_freeze(self, freeze: bool, sender: str) -> None:
        self._only_guardian(sender)
        self.frozen = freeze

    def update_genesis_state(self, height: int, header: bytes,
                             authority_set_id: int, authority_set_hash: bytes,
                             sender: str) -> None:
        self._only_guardian(sender)
        self.latest_block = height
        self.block_height_to_header_hash[height] = header
        self.latest_authority_set_id = authority_set_id
        self.authority_set_id_to_hash[authority_set_id] = authority_set_hash

    def update_block_range_data(self, start_blocks, end_blocks, header_hashes,
                                data_root_commitments, state_root_commitments,
                                end_authority_set_id, end_authority_set_hash,
                                sender: str) -> None:
        self._only_guardian(sender)
        n = len(start_blocks)
        if not (n == len(end_blocks) == len(header_hashes)
                == len(data_root_commitments) == len(state_root_commitments)):
            raise Revert("length mismatch")
        if n == 0:
            raise Revert("empty")
        if start_blocks[0] != self.latest_block:
            raise Revert("first range must extend head")
        for i in range(n):
            if i < n - 1 and end_blocks[i] != start_blocks[i + 1]:
                raise Revert("ranges not contiguous")
            key = abi.range_commitment_key(start_blocks[i], end_blocks[i])
            self.data_root_commitments[key] = data_root_commitments[i]
            self.state_root_commitments[key] = state_root_commitments[i]
            self.range_start_blocks[key] = start_blocks[i]
            self.block_height_to_header_hash[end_blocks[i]] = header_hashes[i]
            self.events.append(Event("HeaderRangeCommitmentStored", dict(
                startBlock=start_blocks[i], endBlock=end_blocks[i],
                dataCommitment=data_root_commitments[i],
                stateCommitment=state_root_commitments[i],
                headerRangeCommitmentTreeSize=
                self.header_range_commitment_tree_size)))
        self.latest_block = end_blocks[-1]
        self.events.append(Event("HeadUpdate", dict(
            blockNumber=self.latest_block, headerHash=header_hashes[-1])))
        self.latest_authority_set_id = end_authority_set_id
        self.authority_set_id_to_hash[end_authority_set_id] = \
            end_authority_set_hash
        self.events.append(Event("AuthoritySetStored", dict(
            authoritySetId=end_authority_set_id,
            authoritySetHash=end_authority_set_hash)))

    # -- header_range ------------------------------------------------------

    def _header_range_input(self, authority_set_id: int,
                            target_block: int) -> bytes:
        trusted_header = self.block_height_to_header_hash.get(
            self.latest_block, self.ZERO32)
        if trusted_header == self.ZERO32:
            raise Revert("TrustedHeaderNotFound")
        authority_set_hash = self.authority_set_id_to_hash.get(
            authority_set_id, self.ZERO32)
        if authority_set_hash == self.ZERO32:
            raise Revert("AuthoritySetNotFound")
        if authority_set_id < self.latest_authority_set_id:
            raise Revert("OldAuthoritySetId")
        if not target_block > self.latest_block:
            raise Revert("target not ahead of head")
        return abi.HeaderRangeInput(
            trusted_block=self.latest_block,
            trusted_header_hash=trusted_header,
            authority_set_id=authority_set_id,
            authority_set_hash=authority_set_hash,
            target_block=target_block).encode()

    def request_header_range(self, authority_set_id: int,
                             target_block: int) -> None:
        input_ = self._header_range_input(authority_set_id, target_block)
        self.gateway.requestCall(
            self.header_range_function_id, input_, self,
            encode_commit_header_range_call(authority_set_id, target_block),
            CALLBACK_GAS_LIMIT)
        self.events.append(Event("HeaderRangeRequested", dict(
            trustedBlock=self.latest_block,
            authoritySetId=authority_set_id, targetBlock=target_block)))

    def commit_header_range(self, authority_set_id: int,
                            target_block: int) -> None:
        if self.frozen:
            raise Revert("ContractFrozen")
        input_ = self._header_range_input(authority_set_id, target_block)
        output = self.gateway.verifiedCall(self.header_range_function_id,
                                           input_)
        if len(output) != 96:
            raise Revert("bad output length")
        out = abi.HeaderRangeOutput.decode(output)
        self.block_height_to_header_hash[target_block] = \
            out.target_header_hash
        key = abi.range_commitment_key(self.latest_block, target_block)
        self.data_root_commitments[key] = out.data_root_commitment
        self.state_root_commitments[key] = out.state_root_commitment
        self.range_start_blocks[key] = self.latest_block
        self.events.append(Event("HeaderRangeCommitmentStored", dict(
            startBlock=self.latest_block, endBlock=target_block,
            dataCommitment=out.data_root_commitment,
            stateCommitment=out.state_root_commitment,
            headerRangeCommitmentTreeSize=
            self.header_range_commitment_tree_size)))
        self.events.append(Event("HeadUpdate", dict(
            blockNumber=target_block,
            headerHash=out.target_header_hash)))
        self.latest_block = target_block
        if authority_set_id > self.latest_authority_set_id:
            self.latest_authority_set_id = authority_set_id

    # -- rotate --------------------------------------------------------------

    def _rotate_input(self, current_authority_set_id: int) -> bytes:
        current_hash = self.authority_set_id_to_hash.get(
            current_authority_set_id, self.ZERO32)
        if current_hash == self.ZERO32:
            raise Revert("AuthoritySetNotFound")
        if current_authority_set_id < self.latest_authority_set_id:
            raise Revert("OldAuthoritySetId")
        if self.authority_set_id_to_hash.get(
                current_authority_set_id + 1, self.ZERO32) != self.ZERO32:
            raise Revert("NextAuthoritySetExists")
        return abi.RotateInput(
            authority_set_id=current_authority_set_id,
            authority_set_hash=current_hash).encode()

    def request_rotate(self, current_authority_set_id: int) -> None:
        input_ = self._rotate_input(current_authority_set_id)
        self.gateway.requestCall(
            self.rotate_function_id, input_, self,
            encode_rotate_call(current_authority_set_id), CALLBACK_GAS_LIMIT)
        self.events.append(Event("RotateRequested", dict(
            currentAuthoritySetId=current_authority_set_id)))

    def rotate(self, current_authority_set_id: int) -> None:
        if self.frozen:
            raise Revert("ContractFrozen")
        input_ = self._rotate_input(current_authority_set_id)
        output = self.gateway.verifiedCall(self.rotate_function_id, input_)
        if len(output) != 32:
            raise Revert("bad output length")
        next_id = current_authority_set_id + 1
        self.authority_set_id_to_hash[next_id] = output
        self.events.append(Event("AuthoritySetStored", dict(
            authoritySetId=next_id, authoritySetHash=output)))
