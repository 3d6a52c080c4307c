"""Security service layer (PyTorch counterpart of
:mod:`dart_planner_tpu.security`; thin and optional, off the card's path).

Functional rebuild of the reference ``src/dart_planner/security/``:
JWT-style RS256 tokens with roles/permissions (auth.py), a token-bucket /
lockout rate limiter (rate_limiter.py), input validation helpers
(validation.py), file-integrity verification (file_verification.py), key
derivation, the keystore and its HMAC tokens (key_manager.py), the
encrypted credential store and its typed helpers, the OS keyring with its
file fallback, the sqlite user database and its CLI (manage_users.py).
Built on the stdlib + ``cryptography``; no module here makes a tensor.
Tokens, password hashes, keystores, credential files, verification
records and user databases written by either package are read by the
other.
"""
from dart_planner_tpu_torch.security.auth import (
    AuthManager,
    Role,
    TokenError,
    User,
    generate_rsa_keypair,
)
from dart_planner_tpu_torch.security.rate_limiter import RateLimitConfig, RateLimiter
from dart_planner_tpu_torch.security.validation import (
    SafetyLimits,
    validate_attitude,
    validate_command_envelope,
    validate_control_command,
    validate_identifier,
    validate_position,
    validate_sensor_data,
    validate_trajectory,
    validate_waypoints,
)
from dart_planner_tpu_torch.security.file_verification import (
    FileRecord,
    FileVerificationManager,
    compute_file_digest,
    create_file_verification,
    verify_file_digest,
    verify_file_integrity,
)

__all__ = [
    "AuthManager",
    "Role",
    "TokenError",
    "User",
    "generate_rsa_keypair",
    "RateLimitConfig",
    "RateLimiter",
    "SafetyLimits",
    "validate_attitude",
    "validate_command_envelope",
    "validate_control_command",
    "validate_identifier",
    "validate_position",
    "validate_sensor_data",
    "validate_trajectory",
    "validate_waypoints",
    "FileRecord",
    "FileVerificationManager",
    "compute_file_digest",
    "create_file_verification",
    "verify_file_digest",
    "verify_file_integrity",
]

from dart_planner_tpu_torch.security.key_derivation import (  # noqa: E402
    KeyDerivationError,
    OSKeyStoreError,
    derive_key_from_passphrase,
    derive_key_from_scrypt,
    generate_secure_key,
    validate_key_strength,
)
from dart_planner_tpu_torch.security.key_manager import (  # noqa: E402
    KeyConfig,
    SecureKeyManager,
    get_key_manager,
    set_key_manager,
)
from dart_planner_tpu_torch.security.credentials import (  # noqa: E402
    Credential,
    SecureCredentialManager,
)

__all__ += [
    "KeyDerivationError",
    "OSKeyStoreError",
    "derive_key_from_passphrase",
    "derive_key_from_scrypt",
    "generate_secure_key",
    "validate_key_strength",
    "KeyConfig",
    "SecureKeyManager",
    "get_key_manager",
    "set_key_manager",
    "Credential",
    "SecureCredentialManager",
]

from dart_planner_tpu_torch.security.db import UserService  # noqa: E402

__all__ += ["UserService"]

from dart_planner_tpu_torch.security.permissions import (  # noqa: E402
    PERMISSION_GROUPS,
    ROLE_MATRIX,
    Permission,
    get_permissions_by_group,
    get_role_permissions,
    get_roles_with_permission,
    has_all_permissions,
    has_any_permission,
    has_legacy_permission,
    has_permission,
)

from dart_planner_tpu_torch.security import credential_helpers  # noqa: E402,F401
from dart_planner_tpu_torch.security import secure_files  # noqa: E402,F401

__all__ += [
    "credential_helpers",
    "secure_files",
    "PERMISSION_GROUPS",
    "ROLE_MATRIX",
    "Permission",
    "get_permissions_by_group",
    "get_role_permissions",
    "get_roles_with_permission",
    "has_all_permissions",
    "has_any_permission",
    "has_legacy_permission",
    "has_permission",
]
