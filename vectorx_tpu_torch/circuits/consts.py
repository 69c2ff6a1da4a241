"""Circuit size bounds — parity with VectorX's circuits/consts.rs.

These are the static shapes every kernel/AIR specializes on (VectorX uses
Rust const-generics; here it is Python-level specialization).
"""

# VectorX: consts.rs:3
DATA_ROOT_OFFSET_FROM_END = 32
# VectorX: consts.rs:6
HEADERS_PER_MAP = 8
# VectorX: consts.rs:9
MAX_HEADER_CHUNK_SIZE = 280
# VectorX: consts.rs:12
BLAKE2B_CHUNK_SIZE_BYTES = 128
# VectorX: consts.rs:16
MAX_HEADER_SIZE = MAX_HEADER_CHUNK_SIZE * BLAKE2B_CHUNK_SIZE_BYTES  # 35_840
# VectorX: consts.rs:19
HASH_SIZE = 32
# VectorX: consts.rs:25
PUBKEY_LENGTH = 32
# VectorX: consts.rs:28
WEIGHT_LENGTH = 8
# VectorX: consts.rs:22
VALIDATOR_LENGTH = PUBKEY_LENGTH + WEIGHT_LENGTH  # 40
# VectorX: consts.rs:31
DELAY_LENGTH = 4
# VectorX: consts.rs:34
CONSENSUS_ENGINE_ID_PREFIX_LENGTH = 6
# VectorX: consts.rs:55
MAX_COMPACT_UINT_BYTES = 5
# VectorX: consts.rs:39-40
MAX_PREFIX_LENGTH = (
    CONSENSUS_ENGINE_ID_PREFIX_LENGTH + MAX_COMPACT_UINT_BYTES + 1 + MAX_COMPACT_UINT_BYTES
)
# VectorX: consts.rs:45
ENCODED_PRECOMMIT_LENGTH = 53
# VectorX: consts.rs:52
MAX_AUTHORITY_SET_SIZE = 300
# VectorX: consts.rs:49
MAX_SUBARRAY_SIZE = MAX_AUTHORITY_SET_SIZE * VALIDATOR_LENGTH + DELAY_LENGTH  # 12_004

# production instantiations (VectorX: bin/header_range_256.rs:15-17,
# bin/header_range_512.rs:15-17, bin/rotate.rs:13-15)
HEADER_RANGE_TREE_SIZE_SMALL = 256
HEADER_RANGE_TREE_SIZE_LARGE = 512
