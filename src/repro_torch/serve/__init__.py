from repro_torch.serve.engine import (  # noqa: F401
    Engine,
    GenerationResult,
    PagedEngine,
)
from repro_torch.serve.layouts import (  # noqa: F401
    CacheLayout,
    LayoutError,
    MoEPagedKVLayout,
    PagedKVLayout,
    StateCacheLayout,
    covers,
    layout_class,
)
from repro_torch.serve.paging import (  # noqa: F401
    OutOfPages,
    PageAccountingError,
    PageAllocator,
    PagedKVCache,
    PrefixCache,
    PrefixMatch,
    init_paged_cache,
)
from repro_torch.serve.sampling import (  # noqa: F401
    act_noise,
    request_noise,
    sample_token,
    sample_tokens_fused,
    top_k_logits,
    top_p_logits,
)
from repro_torch.serve.scheduler import (  # noqa: F401
    ContinuousScheduler,
    KVPageCost,
    NullPageCost,
    Request,
)
