// Native threaded batch sampler for fixed-record binary tensor stores.
//
// Counterpart of hierarchicalprobabilistic3dhuman_tpu/native/batch_sampler.cpp
// with the same C ABI, queue and random draws, and two changes:
//
//  * Stores may hold different record counts (pack_training_stores.py writes
//    every pose, every texture and every background). Per item one draw r
//    picks the record of every store whose count equals the first store's
//    (r % n_0, the rows stay aligned as before); each other store takes its
//    own further draw, rng() % n_s, in store order. In sequential mode store s
//    takes (k * B + i) % n_s. Stores of equal counts give the JAX package's
//    bytes exactly.
//  * Sequential mode takes the window number k from fetch_add's return value,
//    so two workers never build the same window (a load and a separate
//    fetch_add let them).
//
// The training input pipeline's host work (record selection and batch
// assembly from memory-mapped stores of poses / textures / pre-resized
// backgrounds) runs on C++ worker threads, off the Python interpreter lock.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -pthread batch_sampler.cpp -o libbatch_sampler.so
// Interface (ctypes): see data/native_loader.py.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <queue>
#include <random>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Store {
    const uint8_t* data = nullptr;
    size_t mapped_bytes = 0;
    int64_t item_bytes = 0;
    int64_t n_items = 0;
    int fd = -1;
};

struct Batch {
    std::vector<uint8_t> bytes;
};

struct Sampler {
    std::vector<Store> stores;          // one record store per field
    int batch_size = 0;
    uint64_t seed = 0;
    bool shuffle = true;

    std::queue<Batch> ready;
    std::mutex mu;
    std::condition_variable cv_ready;
    std::condition_variable cv_space;
    size_t capacity = 4;
    std::vector<std::thread> workers;
    std::atomic<bool> stop{false};
    std::atomic<uint64_t> batch_counter{0};

    int64_t batch_bytes() const {
        int64_t per_item = 0;
        for (const auto& s : stores) per_item += s.item_bytes;
        return per_item * batch_size;
    }

    void worker_loop(int worker_id) {
        std::mt19937_64 rng(seed + 0x9e3779b97f4a7c15ULL * (worker_id + 1));
        const size_t n_stores = stores.size();
        const int64_t n0 = stores[0].n_items;
        // idx[s * batch_size + i]: the record of store s for item i.
        std::vector<int64_t> idx(n_stores * batch_size);
        while (!stop.load(std::memory_order_relaxed)) {
            Batch b;
            b.bytes.resize(batch_bytes());
            uint8_t* out = b.bytes.data();
            const uint64_t k = batch_counter.fetch_add(1);
            for (int i = 0; i < batch_size; ++i) {
                if (shuffle) {
                    const uint64_t r = rng();
                    for (size_t s = 0; s < n_stores; ++s) {
                        if (stores[s].n_items == n0) {
                            idx[s * batch_size + i] = static_cast<int64_t>(r % n0);
                        }
                    }
                    for (size_t s = 0; s < n_stores; ++s) {
                        const int64_t n = stores[s].n_items;
                        if (n != n0) {
                            idx[s * batch_size + i] = static_cast<int64_t>(rng() % n);
                        }
                    }
                } else {
                    for (size_t s = 0; s < n_stores; ++s) {
                        idx[s * batch_size + i] = static_cast<int64_t>(
                            (k * batch_size + i) % stores[s].n_items);
                    }
                }
            }
            // Assemble: for each field, batch_size contiguous records.
            for (size_t s = 0; s < n_stores; ++s) {
                const Store& st = stores[s];
                for (int i = 0; i < batch_size; ++i) {
                    std::memcpy(out, st.data + idx[s * batch_size + i] * st.item_bytes,
                                st.item_bytes);
                    out += st.item_bytes;
                }
            }
            std::unique_lock<std::mutex> lock(mu);
            cv_space.wait(lock, [&] {
                return ready.size() < capacity || stop.load();
            });
            if (stop.load()) return;
            ready.push(std::move(b));
            cv_ready.notify_one();
        }
    }
};

}  // namespace

extern "C" {

void* bs_create(int batch_size, int n_threads, int capacity, uint64_t seed,
                int shuffle) {
    auto* s = new Sampler();
    s->batch_size = batch_size;
    s->capacity = capacity > 0 ? capacity : 4;
    s->seed = seed;
    s->shuffle = shuffle != 0;
    (void)n_threads;  // threads start in bs_start after stores are added
    return s;
}

// Returns 0 on success.
int bs_add_store(void* handle, const char* path, int64_t item_bytes,
                 int64_t n_items) {
    auto* s = static_cast<Sampler*>(handle);
    Store st;
    st.fd = open(path, O_RDONLY);
    if (st.fd < 0) return -1;
    st.item_bytes = item_bytes;
    st.n_items = n_items;
    st.mapped_bytes = static_cast<size_t>(item_bytes) * n_items;
    void* p = mmap(nullptr, st.mapped_bytes, PROT_READ, MAP_PRIVATE, st.fd, 0);
    if (p == MAP_FAILED) {
        close(st.fd);
        return -2;
    }
    madvise(p, st.mapped_bytes, MADV_WILLNEED);
    st.data = static_cast<const uint8_t*>(p);
    s->stores.push_back(st);
    return 0;
}

// Returns 0 on success. A store of no records never gets here: mmap refuses
// a length of 0, so bs_add_store returns -2 for it.
int bs_start(void* handle, int n_threads) {
    auto* s = static_cast<Sampler*>(handle);
    if (s->stores.empty()) return -1;
    for (int t = 0; t < (n_threads > 0 ? n_threads : 2); ++t) {
        s->workers.emplace_back(&Sampler::worker_loop, s, t);
    }
    return 0;
}

int64_t bs_batch_bytes(void* handle) {
    return static_cast<Sampler*>(handle)->batch_bytes();
}

// Blocks until a batch is ready; copies it into out. Returns 0 on success.
int bs_next(void* handle, uint8_t* out) {
    auto* s = static_cast<Sampler*>(handle);
    std::unique_lock<std::mutex> lock(s->mu);
    s->cv_ready.wait(lock, [&] { return !s->ready.empty() || s->stop.load(); });
    if (s->ready.empty()) return -1;
    Batch b = std::move(s->ready.front());
    s->ready.pop();
    s->cv_space.notify_one();
    lock.unlock();
    std::memcpy(out, b.bytes.data(), b.bytes.size());
    return 0;
}

void bs_destroy(void* handle) {
    auto* s = static_cast<Sampler*>(handle);
    s->stop.store(true);
    s->cv_space.notify_all();
    s->cv_ready.notify_all();
    for (auto& t : s->workers) t.join();
    for (auto& st : s->stores) {
        if (st.data) munmap(const_cast<uint8_t*>(st.data), st.mapped_bytes);
        if (st.fd >= 0) close(st.fd);
    }
    delete s;
}

}  // extern "C"
