// ported from tidb_tpu/native/kvstore.cpp @ 3951242
// Percolator-model MVCC key-value engine.
//
// Reference analog: the in-process storage engine
// pkg/store/mockstore/unistore/tikv/mvcc.go (MVCCStore over badger +
// lockstore) and, behind it, TiKV's txn model: three logical column
// families —
//   data:  (key, start_ts)  -> row value
//   lock:  key              -> {start_ts, primary, op}
//   write: (key, commit_ts) -> {start_ts, op}
// with the 2PC protocol: Prewrite (lock + stage data), Commit (write
// record + unlock), Rollback, and snapshot reads that see the latest
// commit <= read_ts and fail on conflicting locks.
//
// This is a fresh C++17 implementation designed for the TPU framework's
// host runtime: an ordered std::map keyed by user key holding per-key
// version chains (newest-first vectors), guarded by a shared_mutex.  It is
// the transactional row store whose snapshots feed columnarization
// (store/columnar.py); the C ABI below is consumed via ctypes
// (tidb_tpu/store/kv.py).  Scan results are returned through a per-call
// arena so no allocation contracts cross the FFI.

// Durability (reference: unistore's badger-backed MVCC persists all CFs,
// mvcc.go:50): committed writes stream to a write-ahead log; kv_checkpoint
// compacts the whole committed state into a snapshot file and truncates
// the WAL.  In-flight (locked, uncommitted) state is intentionally NOT
// logged — the client lives in the same process, so a crash aborts its
// open transactions exactly like percolator lock cleanup would.
//
// File layout at <path>: "<path>.snap" (replayable compacted stream) +
// "<path>.wal" (appended commit records).  Record:
//   [u8 op][u64 start_ts][u64 commit_ts][u32 klen][u32 vlen][key][value]
// A torn tail record (crash mid-append) is detected and ignored.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <condition_variable>
#include <chrono>
#include <map>
#include <memory>
#include <mutex>
#include <shared_mutex>
#include <string>
#include <vector>

#ifdef _WIN32
#else
#include <unistd.h>
#endif

namespace {

enum ErrCode : int32_t {
  OK = 0,
  ERR_LOCKED = 1,          // conflicting lock -> caller backs off
  ERR_WRITE_CONFLICT = 2,  // newer commit than start_ts
  ERR_NOT_FOUND = 3,
  ERR_TXN_MISMATCH = 4,    // commit/rollback without matching lock
  ERR_ALREADY_ROLLED_BACK = 5,
  ERR_DEADLOCK = 6,        // waits-for cycle: requester is the victim
  ERR_LOCK_WAIT_TIMEOUT = 7,
  ERR_WAL = 8,             // WAL write failed: durability lost, commit refused
};

enum Op : uint8_t { OP_PUT = 0, OP_DELETE = 1, OP_ROLLBACK = 2 };

struct Lock {
  uint64_t start_ts = 0;
  std::string primary;
  Op op = OP_PUT;
  std::string value;  // staged data
  bool present = false;
  // pessimistic locks (tikv KvPessimisticLock analog): taken at DML time,
  // upgraded to a prewrite lock at commit, never staged to the WAL
  bool pessimistic = false;
};

struct WriteRec {
  uint64_t commit_ts;
  uint64_t start_ts;
  Op op;
};

struct VersionChain {
  Lock lock;
  // newest-first by commit_ts
  std::vector<WriteRec> writes;
  // staged/committed values keyed by start_ts
  std::map<uint64_t, std::string> data;
};

// ------------------------------------------------------------------ //
// LSM layer: immutable sorted runs (badger-LSM analog, mvcc.go:50).
//
// The mutable std::map is the MEMTABLE: all locks and fresh writes live
// there.  kv_flush freezes every unlocked key's committed chain into an
// immutable Run — flat sorted key array + columnar version arrays + a
// bloom filter — and erases it from the memtable.  Reads merge memtable
// (newest) over runs (newest-last); compaction merges runs and applies
// the GC safepoint as a filter (gc-by-compaction, not whole-store scan).
// Runs are an in-memory layout: durability stays WAL + checkpoint.
// ------------------------------------------------------------------ //

struct Run {
  std::vector<std::string> keys;      // sorted ascending
  std::vector<uint32_t> woff;         // keys.size()+1 prefix offsets
  std::vector<WriteRec> writes;       // per key newest-first
  std::vector<std::string> vals;      // parallel to writes (PUT payload)
  std::vector<uint64_t> bloom;        // bit array, power-of-two words
  uint64_t bloom_mask = 0;

  static uint64_t h1(const std::string& k) {
    uint64_t h = 1469598103934665603ull;
    for (char c : k) { h ^= static_cast<uint8_t>(c); h *= 1099511628211ull; }
    return h;
  }
  void bloom_build() {
    size_t bits = 64;
    while (bits < keys.size() * 10) bits <<= 1;
    bloom.assign(bits / 64, 0);
    bloom_mask = bits - 1;
    for (const auto& k : keys) {
      uint64_t a = h1(k), b = a * 0x9e3779b97f4a7c15ull + 1;
      bloom[(a & bloom_mask) >> 6] |= 1ull << (a & 63);
      bloom[(b & bloom_mask) >> 6] |= 1ull << (b & 63);
    }
  }
  bool maybe(const std::string& k) const {
    if (bloom.empty()) return false;
    uint64_t a = h1(k), b = a * 0x9e3779b97f4a7c15ull + 1;
    return (bloom[(a & bloom_mask) >> 6] >> (a & 63) & 1)
        && (bloom[(b & bloom_mask) >> 6] >> (b & 63) & 1);
  }
  // index of k, or -1 (binary search over the flat sorted array)
  int64_t find(const std::string& k) const {
    auto it = std::lower_bound(keys.begin(), keys.end(), k);
    if (it == keys.end() || *it != k) return -1;
    return it - keys.begin();
  }
  int64_t lower(const std::string& k) const {
    return std::lower_bound(keys.begin(), keys.end(), k) - keys.begin();
  }
};

struct Store {
  std::map<std::string, VersionChain> keys;
  // immutable sorted runs, NEWEST LAST; shared_ptr so readers finishing
  // under the shared lock never race a compaction swap
  std::vector<std::shared_ptr<Run>> runs;
  uint64_t gc_safepoint = 0;
  size_t flush_threshold = 1 << 16;   // memtable keys before auto-flush
  size_t max_runs = 8;                // compaction trigger
  uint64_t commits_since_check = 0;
  mutable std::shared_mutex mu;
  uint64_t ts_counter = 1;  // simple TSO for embedded use (PD analog)
  // durability (empty path = in-memory only)
  std::string path;
  FILE* wal = nullptr;
  bool sync = false;
  bool wal_failed = false;  // a WAL write failed: refuse further commits
  // pessimistic lock waiting + deadlock detection (detector.go analog):
  // waits_for[waiter_start_ts] = holder_start_ts (a txn waits on at most
  // one key at a time, so single edges suffice)
  std::condition_variable_any lock_cv;
  std::map<uint64_t, uint64_t> waits_for;
};

// true if following waits_for edges from `from` reaches `target`
bool wf_reaches(const Store* s, uint64_t from, uint64_t target) {
  uint64_t cur = from;
  for (size_t hops = 0; hops < s->waits_for.size() + 1; ++hops) {
    auto it = s->waits_for.find(cur);
    if (it == s->waits_for.end()) return false;
    cur = it->second;
    if (cur == target) return true;
  }
  return false;
}

void apply_committed(Store* s, const std::string& key, uint64_t start_ts,
                     uint64_t commit_ts, Op op, const std::string& value) {
  auto& vc = s->keys[key];
  // replay must be idempotent and order-independent: a crash between the
  // checkpoint rename and the WAL truncation leaves records present in
  // BOTH files, so dedupe by (commit_ts, start_ts) and insert at the
  // sorted (newest-first) position rather than blindly at the front
  auto pos = vc.writes.begin();
  for (; pos != vc.writes.end(); ++pos) {
    if (pos->commit_ts == commit_ts && pos->start_ts == start_ts) return;
    if (pos->commit_ts < commit_ts) break;
  }
  if (op == OP_PUT) vc.data[start_ts] = value;
  vc.writes.insert(pos, WriteRec{commit_ts, start_ts, op});
  if (commit_ts > s->ts_counter) s->ts_counter = commit_ts;
  if (start_ts > s->ts_counter) s->ts_counter = start_ts;
}

// Serialize ONE record; returns false on any short write.  The single
// writer shared by the WAL appender and the checkpointer (the reader is
// replay_file) so the on-disk format lives in one place per direction.
bool write_record(FILE* f, const std::string& key, uint64_t start_ts,
                  uint64_t commit_ts, Op op, const std::string& value) {
  uint8_t o = static_cast<uint8_t>(op);
  uint32_t kl = key.size(), vl = (op == OP_PUT) ? value.size() : 0;
  if (std::fwrite(&o, 1, 1, f) != 1) return false;
  if (std::fwrite(&start_ts, 8, 1, f) != 1) return false;
  if (std::fwrite(&commit_ts, 8, 1, f) != 1) return false;
  if (std::fwrite(&kl, 4, 1, f) != 1) return false;
  if (std::fwrite(&vl, 4, 1, f) != 1) return false;
  if (kl && std::fwrite(key.data(), 1, kl, f) != kl) return false;
  if (vl && std::fwrite(value.data(), 1, vl, f) != vl) return false;
  return true;
}

// Append + flush one commit record.  Any failure poisons the WAL
// (wal_failed): the caller fails the commit and all later ones — never
// silently degrade to acking non-durable writes.
bool log_commit(Store* s, const std::string& key, uint64_t start_ts,
                uint64_t commit_ts, Op op, const std::string& value) {
  if (s->wal == nullptr) return true;
  bool ok = write_record(s->wal, key, start_ts, commit_ts, op, value);
  ok = ok && std::fflush(s->wal) == 0;
#ifndef _WIN32
  if (ok && s->sync) ok = fdatasync(fileno(s->wal)) == 0;
#endif
  return ok;
}

// Replay one record stream; stops cleanly at a torn tail.  Returns the
// byte offset of the last complete record so the caller can truncate the
// tear before appending (appending after garbage would strand every
// later record behind an unparseable header).
long replay_file(Store* s, const std::string& fname) {
  FILE* f = std::fopen(fname.c_str(), "rb");
  if (f == nullptr) return 0;
  long good = 0;
  for (;;) {
    uint8_t o;
    uint64_t sts, cts;
    uint32_t kl, vl;
    if (std::fread(&o, 1, 1, f) != 1) break;
    if (std::fread(&sts, 8, 1, f) != 1) break;
    if (std::fread(&cts, 8, 1, f) != 1) break;
    if (std::fread(&kl, 4, 1, f) != 1) break;
    if (std::fread(&vl, 4, 1, f) != 1) break;
    std::string key(kl, '\0'), val(vl, '\0');
    if (kl && std::fread(key.data(), 1, kl, f) != kl) break;
    if (vl && std::fread(val.data(), 1, vl, f) != vl) break;
    apply_committed(s, key, sts, cts, static_cast<Op>(o), val);
    good = std::ftell(f);
  }
  std::fclose(f);
  return good;
}

struct Arena {
  std::vector<std::string> bufs;
  const char* push(const std::string& s) {
    bufs.push_back(s);
    return bufs.back().data();
  }
};

// thread-local: each OS thread gets its own result buffer, so a kv_get
// pointer stays valid until the *same* thread's next kv_get — the ctypes
// caller copies immediately after return on that thread.
thread_local std::string g_err;

int32_t check_lock_conflict(const VersionChain& vc, uint64_t read_ts,
                            uint64_t caller_start_ts) {
  if (!vc.lock.present) return OK;
  if (vc.lock.pessimistic) return OK;  // no staged write: reads pass
  if (vc.lock.start_ts == caller_start_ts) return OK;  // own lock
  if (vc.lock.start_ts <= read_ts) return ERR_LOCKED;
  return OK;  // lock from a future txn doesn't block this snapshot
}

const WriteRec* latest_write_le(const VersionChain& vc, uint64_t ts) {
  for (const auto& w : vc.writes) {
    if (w.commit_ts <= ts && w.op != OP_ROLLBACK) return &w;
  }
  return nullptr;
}

// newest write <= ts for key across the runs (newest run first); sets
// *val to the PUT payload.  Returns false when no run holds one.
bool runs_latest_le(const Store* s, const std::string& k, uint64_t ts,
                    const WriteRec** w_out, const std::string** val_out) {
  for (auto rit = s->runs.rbegin(); rit != s->runs.rend(); ++rit) {
    const Run& r = **rit;
    if (!r.maybe(k)) continue;
    int64_t i = r.find(k);
    if (i < 0) continue;
    for (uint32_t j = r.woff[i]; j < r.woff[i + 1]; ++j) {
      const WriteRec& w = r.writes[j];
      if (w.commit_ts <= ts && w.op != OP_ROLLBACK) {
        *w_out = &w;
        *val_out = &r.vals[j];
        return true;
      }
    }
  }
  return false;
}

// conflict view for prewrite/pessimistic-lock: newest non-rollback commit
// across memtable+runs, plus whether a rollback record exists for
// start_ts.  (memtable is always newer than any run for a key.)
void conflict_view(const Store* s, const VersionChain* vc,
                   const std::string& k, uint64_t start_ts,
                   uint64_t* newest_commit, bool* rolled_back) {
  *newest_commit = 0;
  *rolled_back = false;
  auto scan_list = [&](const WriteRec* ws, size_t n) {
    for (size_t i = 0; i < n; ++i) {
      const WriteRec& w = ws[i];
      if (w.op == OP_ROLLBACK) {
        if (w.start_ts == start_ts) *rolled_back = true;
        continue;
      }
      if (*newest_commit == 0) *newest_commit = w.commit_ts;
      // keep scanning only for rollback-by-start_ts
    }
  };
  if (vc != nullptr && !vc->writes.empty())
    scan_list(vc->writes.data(), vc->writes.size());
  for (auto rit = s->runs.rbegin(); rit != s->runs.rend(); ++rit) {
    const Run& r = **rit;
    if (!r.maybe(k)) continue;
    int64_t i = r.find(k);
    if (i < 0) continue;
    scan_list(&r.writes[r.woff[i]], r.woff[i + 1] - r.woff[i]);
  }
}

// GC filter shared by kv_gc (memtable) and compaction (runs): which
// writes of a newest-first chain survive `safepoint`.
std::vector<char> gc_live_mask(const std::vector<WriteRec>& ws,
                               uint64_t safepoint) {
  const WriteRec* keep = nullptr;
  for (const auto& w : ws)
    if (w.commit_ts <= safepoint && w.op != OP_ROLLBACK) { keep = &w; break; }
  std::vector<char> live(ws.size(), 0);
  for (size_t i = 0; i < ws.size(); ++i) {
    const WriteRec& w = ws[i];
    live[i] = w.commit_ts > safepoint
              || (keep && w.op != OP_ROLLBACK
                  && w.commit_ts == keep->commit_ts);
  }
  return live;
}

// merge every run (newest-last) into one, applying the GC safepoint as a
// compaction filter.  Caller holds the unique lock.
int64_t compact_runs(Store* s) {
  if (s->runs.size() <= 1 && s->gc_safepoint == 0) return 0;
  auto merged = std::make_shared<Run>();
  int64_t dropped = 0;
  // per-run cursors over sorted keys
  std::vector<size_t> cur(s->runs.size(), 0);
  for (;;) {
    const std::string* next = nullptr;
    for (size_t r = 0; r < s->runs.size(); ++r) {
      if (cur[r] >= s->runs[r]->keys.size()) continue;
      const std::string& k = s->runs[r]->keys[cur[r]];
      if (next == nullptr || k < *next) next = &k;
    }
    if (next == nullptr) break;
    std::string key = *next;
    // newest-first chain: newest run's records first
    std::vector<WriteRec> ws;
    std::vector<std::string> vs;
    for (size_t r = s->runs.size(); r-- > 0;) {
      Run& src = *s->runs[r];
      if (cur[r] >= src.keys.size() || src.keys[cur[r]] != key) continue;
      size_t i = cur[r]++;
      for (uint32_t j = src.woff[i]; j < src.woff[i + 1]; ++j) {
        ws.push_back(src.writes[j]);
        vs.push_back(std::move(src.vals[j]));
      }
    }
    auto live = gc_live_mask(ws, s->gc_safepoint);
    std::vector<WriteRec> kept_w;
    std::vector<std::string> kept_v;
    for (size_t i = 0; i < ws.size(); ++i) {
      if (live[i]) {
        kept_w.push_back(ws[i]);
        kept_v.push_back(std::move(vs[i]));
      } else {
        ++dropped;
      }
    }
    // fully dead key (tombstoned before the safepoint): drop entirely
    bool all_dead = true;
    for (const auto& w : kept_w)
      if (w.op != OP_ROLLBACK) { all_dead = false; break; }
    if (kept_w.empty() || all_dead) continue;
    merged->keys.push_back(std::move(key));
    for (size_t i = 0; i < kept_w.size(); ++i) {
      merged->writes.push_back(kept_w[i]);
      merged->vals.push_back(std::move(kept_v[i]));
    }
    merged->woff.push_back(
        static_cast<uint32_t>(merged->writes.size()));
  }
  // woff holds per-key END offsets so far; convert to prefix offsets
  std::vector<uint32_t> off(merged->keys.size() + 1, 0);
  for (size_t i = 0; i < merged->keys.size(); ++i)
    off[i + 1] = merged->woff[i];
  merged->woff = std::move(off);
  merged->bloom_build();
  s->runs.clear();
  if (!merged->keys.empty()) s->runs.push_back(std::move(merged));
  return dropped;
}

// freeze every unlocked memtable key's committed chain into a new run.
// Caller holds the unique lock.  Returns keys moved.
int64_t flush_memtable(Store* s) {
  auto run = std::make_shared<Run>();
  run->woff.push_back(0);
  for (auto it = s->keys.begin(); it != s->keys.end();) {
    VersionChain& vc = it->second;
    if (vc.lock.present || vc.writes.empty()) { ++it; continue; }
    run->keys.push_back(it->first);
    for (const auto& w : vc.writes) {
      run->writes.push_back(w);
      auto dit = vc.data.find(w.start_ts);
      run->vals.push_back(
          (w.op == OP_PUT && dit != vc.data.end()) ? dit->second
                                                   : std::string());
    }
    run->woff.push_back(static_cast<uint32_t>(run->writes.size()));
    it = s->keys.erase(it);
  }
  if (run->keys.empty()) return 0;
  int64_t moved = static_cast<int64_t>(run->keys.size());
  run->bloom_build();
  s->runs.push_back(std::move(run));
  if (s->runs.size() > s->max_runs) compact_runs(s);
  return moved;
}

}  // namespace

extern "C" {

void* kv_open() { return new Store(); }

// Durable open: replay <path>.snap + <path>.wal, then append to the WAL.
// sync != 0 fdatasyncs every commit record (fflush-only otherwise).
void* kv_open_at(const char* path, int32_t plen, uint8_t sync) {
  auto* s = new Store();
  s->path.assign(path, plen);
  s->sync = sync != 0;
  replay_file(s, s->path + ".snap");
  long wal_good = replay_file(s, s->path + ".wal");
  s->ts_counter += 1;  // strictly above anything persisted
#ifndef _WIN32
  truncate((s->path + ".wal").c_str(), wal_good);  // drop any torn tail
#else
  (void)wal_good;
#endif
  s->wal = std::fopen((s->path + ".wal").c_str(), "ab");
  if (s->wal == nullptr) {  // unwritable dir/disk: fail loudly, never
    delete s;               // silently degrade to non-durable
    return nullptr;
  }
  return s;
}

// Compact the committed state into <path>.snap and truncate the WAL.
// Returns number of records written, or -1 when the store is in-memory.
int64_t kv_checkpoint(void* h) {
  auto* s = static_cast<Store*>(h);
  std::unique_lock lk(s->mu);
  if (s->path.empty()) return -1;
  std::string tmp = s->path + ".snap.tmp";
  FILE* f = std::fopen(tmp.c_str(), "wb");
  if (f == nullptr) return -1;
  int64_t n = 0;
  bool ok = true;
  // runs first (older data), then memtable; replay dedupes by
  // (commit_ts, start_ts) and orders by insertion, so either works
  for (const auto& run : s->runs) {
    if (!ok) break;
    for (size_t i = 0; ok && i < run->keys.size(); ++i) {
      for (uint32_t j = run->woff[i + 1]; j-- > run->woff[i];) {
        const WriteRec& w = run->writes[j];   // oldest-first
        if (w.op == OP_ROLLBACK) continue;
        ok = write_record(f, run->keys[i], w.start_ts, w.commit_ts,
                          w.op, run->vals[j]);
        ++n;
        if (!ok) break;
      }
    }
  }
  for (const auto& [key, vc] : s->keys) {
    if (!ok) break;
    // oldest-first so replay's insertion rebuilds newest-first
    for (auto it = vc.writes.rbegin(); ok && it != vc.writes.rend(); ++it) {
      if (it->op == OP_ROLLBACK) continue;
      std::string val;
      if (it->op == OP_PUT) {
        auto dit = vc.data.find(it->start_ts);
        if (dit == vc.data.end()) continue;
        val = dit->second;
      }
      ok = write_record(f, key, it->start_ts, it->commit_ts, it->op, val);
      ++n;
    }
  }
  ok = ok && std::fflush(f) == 0;
#ifndef _WIN32
  ok = ok && fdatasync(fileno(f)) == 0;
#endif
  std::fclose(f);
  if (!ok) {                       // partial snapshot: keep .snap + WAL
    std::remove(tmp.c_str());
    return -2;
  }
  if (std::rename(tmp.c_str(), (s->path + ".snap").c_str()) != 0) {
    std::remove(tmp.c_str());
    return -2;
  }
  if (s->wal != nullptr) {
    std::fclose(s->wal);
    s->wal = std::fopen((s->path + ".wal").c_str(), "wb");  // truncate
    if (s->wal == nullptr) {
      s->wal_failed = true;
      return -2;  // caller must treat as fatal
    }
  }
  return n;
}

void kv_close(void* h) {
  auto* s = static_cast<Store*>(h);
  if (s->wal != nullptr) std::fclose(s->wal);
  delete s;
}

uint64_t kv_alloc_ts(void* h) {
  auto* s = static_cast<Store*>(h);
  std::unique_lock lk(s->mu);
  return ++s->ts_counter;
}

// Prewrite one mutation. op: 0=put, 1=delete.
int32_t kv_prewrite(void* h, const char* key, int32_t klen, const char* val,
                    int32_t vlen, const char* primary, int32_t plen,
                    uint64_t start_ts, uint8_t op) {
  auto* s = static_cast<Store*>(h);
  std::unique_lock lk(s->mu);
  std::string k(key, klen);
  auto& vc = s->keys[k];
  if (vc.lock.present && vc.lock.start_ts != start_ts) {
    return ERR_LOCKED;
  }
  // prewriting over our own pessimistic lock skips the conflict check:
  // kv_pessimistic_lock already validated against for_update_ts, and
  // commits in (start_ts, for_update_ts] are permitted in this mode
  bool own_pess = vc.lock.present && vc.lock.pessimistic
                  && vc.lock.start_ts == start_ts;
  uint64_t newest = 0;
  bool rolled_back = false;
  conflict_view(s, &vc, k, start_ts, &newest, &rolled_back);
  if (!own_pess) {
    // write conflict: any commit after start_ts (memtable or runs)
    for (const auto& w : vc.writes) {
      if (w.commit_ts > start_ts && w.op == OP_ROLLBACK
          && w.start_ts == start_ts) {
        return ERR_ALREADY_ROLLED_BACK;
      }
      break;
    }
    if (newest > start_ts) return ERR_WRITE_CONFLICT;
  }
  // rollback record for this exact start_ts => txn was aborted
  if (rolled_back) return ERR_ALREADY_ROLLED_BACK;
  vc.lock.present = true;
  vc.lock.pessimistic = false;   // upgrade: pessimistic -> prewrite lock
  vc.lock.start_ts = start_ts;
  vc.lock.primary.assign(primary, plen);
  vc.lock.op = static_cast<Op>(op);
  vc.lock.value.assign(val ? val : "", val ? vlen : 0);
  return OK;
}

int32_t kv_commit(void* h, const char* key, int32_t klen, uint64_t start_ts,
                  uint64_t commit_ts) {
  auto* s = static_cast<Store*>(h);
  std::unique_lock lk(s->mu);
  auto it = s->keys.find(std::string(key, klen));
  if (it == s->keys.end()) return ERR_TXN_MISMATCH;
  auto& vc = it->second;
  if (!vc.lock.present || vc.lock.start_ts != start_ts) {
    // idempotent commit: already committed?
    for (const auto& w : vc.writes) {
      if (w.start_ts == start_ts && w.op != OP_ROLLBACK) return OK;
    }
    return ERR_TXN_MISMATCH;
  }
  if (vc.lock.pessimistic) return ERR_TXN_MISMATCH;  // prewrite first
  if (s->wal_failed) return ERR_WAL;
  // log BEFORE applying: a failed WAL write must fail the commit, not
  // silently ack a non-durable one
  if (s->wal != nullptr) {
    if (!log_commit(s, it->first, start_ts, commit_ts, vc.lock.op,
                    vc.lock.value)) {
      s->wal_failed = true;
      return ERR_WAL;
    }
  }
  if (vc.lock.op == OP_PUT) {
    vc.data[start_ts] = std::move(vc.lock.value);
  }
  vc.writes.insert(vc.writes.begin(),
                   WriteRec{commit_ts, start_ts, vc.lock.op});
  vc.lock = Lock{};
  s->lock_cv.notify_all();
  // amortized auto-flush: freeze the memtable once it outgrows the
  // threshold (checked every 1024 commits to keep the hot path flat)
  if (++s->commits_since_check >= 1024) {
    s->commits_since_check = 0;
    if (s->keys.size() >= s->flush_threshold) flush_memtable(s);
  }
  return OK;
}

int32_t kv_rollback(void* h, const char* key, int32_t klen,
                    uint64_t start_ts) {
  auto* s = static_cast<Store*>(h);
  std::unique_lock lk(s->mu);
  auto& vc = s->keys[std::string(key, klen)];
  if (vc.lock.present && vc.lock.start_ts == start_ts) {
    vc.lock = Lock{};
    s->lock_cv.notify_all();
  }
  // tombstone so a late prewrite of the same txn fails
  vc.writes.insert(vc.writes.begin(),
                   WriteRec{start_ts, start_ts, OP_ROLLBACK});
  vc.data.erase(start_ts);
  return OK;
}

// Snapshot point get.  out/out_len point into a thread-local buffer valid
// until the next kv_get on the same thread.
int32_t kv_get(void* h, const char* key, int32_t klen, uint64_t ts,
               const char** out, int32_t* out_len) {
  auto* s = static_cast<Store*>(h);
  std::shared_lock lk(s->mu);
  std::string k(key, klen);
  auto it = s->keys.find(k);
  if (it != s->keys.end()) {
    const auto& vc = it->second;
    int32_t lc = check_lock_conflict(vc, ts, 0);
    if (lc != OK) return lc;
    const WriteRec* w = latest_write_le(vc, ts);
    if (w != nullptr) {   // memtable writes are newer than any run's
      if (w->op == OP_DELETE) return ERR_NOT_FOUND;
      auto dit = vc.data.find(w->start_ts);
      if (dit == vc.data.end()) return ERR_NOT_FOUND;
      g_err = dit->second;
      *out = g_err.data();
      *out_len = static_cast<int32_t>(g_err.size());
      return OK;
    }
  }
  const WriteRec* w = nullptr;
  const std::string* val = nullptr;
  if (!runs_latest_le(s, k, ts, &w, &val)) return ERR_NOT_FOUND;
  if (w->op == OP_DELETE) return ERR_NOT_FOUND;
  g_err = *val;
  *out = g_err.data();
  *out_len = static_cast<int32_t>(g_err.size());
  return OK;
}

// Snapshot range scan [start, end).  Returns number of pairs (<= limit),
// or the negative error code on lock conflict.  Results are written as
// length-prefixed records into the caller-provided buffer:
//   [u32 klen][key][u32 vlen][value] ...
// If the buffer is too small, returns what fits and sets *truncated=1 with
// *resume_key of the next key (paging analog).
int32_t kv_scan(void* h, const char* start, int32_t slen, const char* end,
                int32_t elen, uint64_t ts, int32_t limit, char* buf,
                int64_t buf_cap, int64_t* used, uint8_t* truncated) {
  auto* s = static_cast<Store*>(h);
  std::shared_lock lk(s->mu);
  std::string sk(start, slen), ek(end, elen);
  auto it = s->keys.lower_bound(sk);
  // k-way merge: memtable iterator + one cursor per run (runs sorted)
  std::vector<size_t> rcur(s->runs.size());
  for (size_t r = 0; r < s->runs.size(); ++r)
    rcur[r] = static_cast<size_t>(s->runs[r]->lower(sk));
  int32_t n = 0;
  int64_t off = 0;
  *truncated = 0;
  while (n < limit) {
    // smallest key across sources
    const std::string* next = nullptr;
    bool from_mem = false;
    if (it != s->keys.end() && (ek.empty() || it->first < ek)) {
      next = &it->first;
      from_mem = true;
    }
    for (size_t r = 0; r < s->runs.size(); ++r) {
      const Run& run = *s->runs[r];
      if (rcur[r] >= run.keys.size()) continue;
      const std::string& k = run.keys[rcur[r]];
      if (!ek.empty() && k >= ek) continue;
      if (next == nullptr || k < *next) {
        next = &k;
        from_mem = false;
      }
    }
    if (next == nullptr) break;
    std::string key = *next;
    // resolve version: memtable first (newer), then runs
    const std::string* val = nullptr;
    bool deleted = false;
    if (from_mem || (it != s->keys.end() && it->first == key)) {
      const auto& vc = it->second;
      if (check_lock_conflict(vc, ts, 0) != OK) return -ERR_LOCKED;
      const WriteRec* w = latest_write_le(vc, ts);
      if (w != nullptr) {
        if (w->op == OP_DELETE) {
          deleted = true;
        } else {
          auto dit = vc.data.find(w->start_ts);
          if (dit != vc.data.end()) val = &dit->second;
          else deleted = true;
        }
      }
      ++it;
    }
    if (val == nullptr && !deleted) {
      // run cursors already sit on this key: resolve newest-run-first
      // without re-searching (the per-key binary search would dominate)
      for (size_t r = s->runs.size(); r-- > 0 && val == nullptr
                                      && !deleted;) {
        const Run& run = *s->runs[r];
        if (rcur[r] >= run.keys.size() || run.keys[rcur[r]] != key)
          continue;
        for (uint32_t j = run.woff[rcur[r]];
             j < run.woff[rcur[r] + 1]; ++j) {
          const WriteRec& w = run.writes[j];
          if (w.commit_ts <= ts && w.op != OP_ROLLBACK) {
            if (w.op == OP_PUT) val = &run.vals[j];
            else deleted = true;
            break;
          }
        }
      }
    }
    // advance every run cursor sitting on this key
    for (size_t r = 0; r < s->runs.size(); ++r) {
      const Run& run = *s->runs[r];
      if (rcur[r] < run.keys.size() && run.keys[rcur[r]] == key)
        ++rcur[r];
    }
    if (val == nullptr) continue;
    int64_t need = 8 + static_cast<int64_t>(key.size())
                   + static_cast<int64_t>(val->size());
    if (off + need > buf_cap) {
      *truncated = 1;
      break;
    }
    uint32_t kl = key.size(), vl = val->size();
    std::memcpy(buf + off, &kl, 4); off += 4;
    std::memcpy(buf + off, key.data(), kl); off += kl;
    std::memcpy(buf + off, &vl, 4); off += 4;
    std::memcpy(buf + off, val->data(), vl); off += vl;
    ++n;
  }
  *used = off;
  return n;
}

// Full version history of one key, newest-first (status-API /mvcc
// introspection; reference pkg/server/handler mvcc handlers).  Walks the
// memtable chain then runs newest-first, skipping rollbacks.  Per
// version: [commit_ts u64][op u8][vlen i32][payload].  Returns the
// emitted count; *truncated set when max_n or the buffer cut it short.
int32_t kv_versions(void* h, const char* key, int32_t klen, int32_t max_n,
                    char* buf, int64_t buf_cap, int64_t* used,
                    uint8_t* truncated) {
  auto* s = static_cast<Store*>(h);
  std::shared_lock lk(s->mu);
  std::string k(key, klen);
  int32_t n = 0;
  int64_t off = 0;
  *truncated = 0;
  bool full = false;
  auto emit = [&](const WriteRec& w, const std::string* val) {
    if (n >= max_n) { *truncated = 1; full = true; return; }
    int32_t vlen = (w.op == OP_PUT && val != nullptr)
        ? static_cast<int32_t>(val->size()) : 0;
    if (off + 13 + vlen > buf_cap) { *truncated = 1; full = true; return; }
    std::memcpy(buf + off, &w.commit_ts, 8); off += 8;
    buf[off++] = static_cast<char>(w.op);
    std::memcpy(buf + off, &vlen, 4); off += 4;
    if (vlen > 0) { std::memcpy(buf + off, val->data(), vlen); off += vlen; }
    ++n;
  };
  auto it = s->keys.find(k);
  if (it != s->keys.end()) {
    for (const auto& w : it->second.writes) {
      if (full) break;
      if (w.op == OP_ROLLBACK) continue;
      const std::string* val = nullptr;
      if (w.op == OP_PUT) {
        auto dit = it->second.data.find(w.start_ts);
        if (dit != it->second.data.end()) val = &dit->second;
      }
      emit(w, val);
    }
  }
  for (auto rit = s->runs.rbegin(); !full && rit != s->runs.rend(); ++rit) {
    const Run& r = **rit;
    if (!r.maybe(k)) continue;
    int64_t i = r.find(k);
    if (i < 0) continue;
    for (uint32_t j = r.woff[i]; !full && j < r.woff[i + 1]; ++j) {
      const WriteRec& w = r.writes[j];
      if (w.op == OP_ROLLBACK) continue;
      emit(w, w.op == OP_PUT ? &r.vals[j] : nullptr);
    }
  }
  *used = off;
  return n;
}

// MVCC garbage collection: drop versions not visible at safepoint
// (gcworker analog, pkg/store/gcworker/gc_worker.go).
int64_t kv_gc(void* h, uint64_t safepoint) {
  auto* s = static_cast<Store*>(h);
  std::unique_lock lk(s->mu);
  int64_t dropped = 0;
  for (auto it = s->keys.begin(); it != s->keys.end();) {
    auto& vc = it->second;
    const WriteRec* keep = latest_write_le(vc, safepoint);
    std::vector<WriteRec> nw;
    for (const auto& w : vc.writes) {
      bool live = w.commit_ts > safepoint || (keep && w.commit_ts == keep->commit_ts);
      if (live) {
        nw.push_back(w);
      } else {
        vc.data.erase(w.start_ts);
        ++dropped;
      }
    }
    vc.writes = std::move(nw);
    if (vc.writes.empty() && !vc.lock.present && vc.data.empty()) {
      it = s->keys.erase(it);
    } else {
      ++it;
    }
  }
  // runs GC by COMPACTION FILTER: record the safepoint and merge, so
  // dead versions drop during the rewrite instead of a dedicated scan
  s->gc_safepoint = safepoint;
  dropped += compact_runs(s);
  return dropped;
}

// Freeze unlocked memtable keys into an immutable sorted run.
int64_t kv_flush(void* h) {
  auto* s = static_cast<Store*>(h);
  std::unique_lock lk(s->mu);
  return flush_memtable(s);
}

int64_t kv_run_count(void* h) {
  auto* s = static_cast<Store*>(h);
  std::shared_lock lk(s->mu);
  return static_cast<int64_t>(s->runs.size());
}

// In-process point-get micro-bench (bench harness only): n random gets
// over the CURRENT committed state, returns total nanoseconds.  Lives in
// C++ so the measurement excludes ctypes call overhead.
int64_t kv_bench_gets(void* h, int64_t n, uint64_t seed, uint64_t ts) {
  auto* s = static_cast<Store*>(h);
  // collect a key sample under the lock (memtable + runs)
  std::vector<std::string> sample;
  {
    std::shared_lock lk(s->mu);
    size_t total = s->keys.size();
    for (const auto& run : s->runs) total += run->keys.size();
    size_t stride = total / 65536 + 1;   // uniform over the key space
    size_t i = 0;
    for (const auto& [k, vc] : s->keys) {
      (void)vc;
      if (i++ % stride == 0) sample.push_back(k);
    }
    for (const auto& run : s->runs) {
      for (size_t j = 0; j < run->keys.size(); ++j) {
        if (i++ % stride == 0) sample.push_back(run->keys[j]);
      }
    }
  }
  if (sample.empty()) return 0;
  uint64_t x = seed | 1;
  const char* out;
  int32_t out_len;
  auto t0 = std::chrono::steady_clock::now();
  for (int64_t i = 0; i < n; ++i) {
    x ^= x << 13; x ^= x >> 7; x ^= x << 17;   // xorshift
    const std::string& k = sample[x % sample.size()];
    kv_get(h, k.data(), static_cast<int32_t>(k.size()), ts, &out,
           &out_len);
  }
  auto t1 = std::chrono::steady_clock::now();
  return std::chrono::duration_cast<std::chrono::nanoseconds>(t1 - t0)
      .count();
}

void kv_set_flush_threshold(void* h, int64_t n) {
  auto* s = static_cast<Store*>(h);
  std::unique_lock lk(s->mu);
  s->flush_threshold = n > 0 ? static_cast<size_t>(n) : (1ull << 62);
}

// Acquire a pessimistic lock (KvPessimisticLock, unistore/tikv/server.go
// :237).  Blocks up to wait_ms while another txn holds the key, with
// waits-for-cycle detection (detector.go): the REQUESTER is the deadlock
// victim.  for_update_ts guards against commits later than what the
// statement read (write-conflict -> caller refreshes and retries).
int32_t kv_pessimistic_lock(void* h, const char* key, int32_t klen,
                            const char* primary, int32_t plen,
                            uint64_t start_ts, uint64_t for_update_ts,
                            int32_t wait_ms) {
  auto* s = static_cast<Store*>(h);
  std::unique_lock lk(s->mu);
  std::string k(key, klen);
  auto deadline = std::chrono::steady_clock::now()
                  + std::chrono::milliseconds(wait_ms);
  for (;;) {
    auto& vc = s->keys[k];
    uint64_t newest = 0;
    bool rolled_back = false;
    conflict_view(s, &vc, k, start_ts, &newest, &rolled_back);
    if (rolled_back) return ERR_ALREADY_ROLLED_BACK;
    if (newest > for_update_ts) return ERR_WRITE_CONFLICT;
    if (!vc.lock.present) {
      vc.lock.present = true;
      vc.lock.pessimistic = true;
      vc.lock.start_ts = start_ts;
      vc.lock.primary.assign(primary, plen);
      vc.lock.op = OP_PUT;
      vc.lock.value.clear();
      return OK;
    }
    if (vc.lock.start_ts == start_ts) return OK;  // re-entrant
    uint64_t holder = vc.lock.start_ts;
    // adding edge start_ts -> holder: cycle iff holder (transitively)
    // already waits on us
    if (wf_reaches(s, holder, start_ts)) return ERR_DEADLOCK;
    s->waits_for[start_ts] = holder;
    bool timed_out = !s->lock_cv.wait_until(lk, deadline, [&] {
      auto it2 = s->keys.find(k);
      return it2 == s->keys.end() || !it2->second.lock.present
             || it2->second.lock.start_ts == start_ts;
    });
    s->waits_for.erase(start_ts);
    if (timed_out) return ERR_LOCK_WAIT_TIMEOUT;
  }
}

// Release a pessimistic lock without aborting the txn (statement rollback
// / unlock of keys that were locked but not written).
int32_t kv_pessimistic_rollback(void* h, const char* key, int32_t klen,
                                uint64_t start_ts) {
  auto* s = static_cast<Store*>(h);
  std::unique_lock lk(s->mu);
  auto it = s->keys.find(std::string(key, klen));
  if (it == s->keys.end()) return OK;
  auto& vc = it->second;
  if (vc.lock.present && vc.lock.pessimistic
      && vc.lock.start_ts == start_ts) {
    vc.lock = Lock{};
    s->lock_cv.notify_all();
  }
  return OK;
}

int64_t kv_num_keys(void* h) {
  auto* s = static_cast<Store*>(h);
  std::shared_lock lk(s->mu);
  // distinct keys across memtable + runs (a flushed key may have been
  // re-written into the memtable; count it once)
  if (s->runs.empty()) return static_cast<int64_t>(s->keys.size());
  int64_t n = static_cast<int64_t>(s->keys.size());
  for (const auto& run : s->runs) {
    for (const auto& k : run->keys) {
      if (s->keys.find(k) == s->keys.end()) ++n;
    }
  }
  if (s->runs.size() > 1) {
    // subtract keys double-counted across runs
    for (size_t a = 1; a < s->runs.size(); ++a) {
      for (const auto& k : s->runs[a]->keys) {
        for (size_t b = 0; b < a; ++b) {
          if (s->runs[b]->find(k) >= 0) {
            if (s->keys.find(k) == s->keys.end()) --n;
            break;
          }
        }
      }
    }
  }
  return n;
}

}  // extern "C"
